"""The port's converters against the JAX package on the CPU:
eamg_tpu_torch/models/gqa_convert.py (convert-gqa),
models/import_torch.py and tools/convert.py (export-pt, convert-pt),
tools/gqa_recover.py (gqa-recover) and their subcommands.

The torch side runs in one subprocess (tests/torch_port_variants.py, task
"convert"). Tolerances:
- convert_mha_to_gqa: bit-equal to JAX's at every divisor of n_head (8:
  1, 2, 4, 8; 6: 1, 2, 3, 6), in f32 and bf16; a non-divisor and a GQA
  source refused; the directory convert_checkpoint_dir writes loads in
  JAX's load_checkpoint with arrays, config, step, key and extra equal to
  JAX's own conversion's, and no optimizer state;
- export-pt: both dialects give JAX's key names, and the .pt loads through
  JAX's load_reference_checkpoint with the source's values cast to f32;
  MoE, int8 and GQA trees refused; convert-pt of a .pt (JAX's kv-dialect
  file and the port's trainer-dialect one, with and without
  --serving-arch) gives JAX's checkpoint: equal arrays, config, vocabulary
  and extra;
- run_gqa_recovery on a small Scheme-B3 checkpoint (40 rows, 2 steps):
  the three perplexities within 1e-4 relative of JAX's, the same keys and
  step count;
- the CLI: each subcommand's --help has JAX's flags (plus --device for
  gqa-recover, the one with device work); convert-gqa, convert-pt and
  export-pt print what JAX's print (paths aside); gqa-recover --device cpu
  prints JAX's keys and perplexities.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import sys
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.cli import main as jax_cli
from eamg_tpu.models.gpt import GPTConfig, init_params
from eamg_tpu.models.gqa_convert import (convert_checkpoint_dir,
                                         convert_mha_to_gqa)
from eamg_tpu.models import import_torch
from eamg_tpu.models.import_torch import (export_reference_checkpoint,
                                          export_state_dict,
                                          load_reference_checkpoint)
from eamg_tpu.tokenizer import SchemeB3
from eamg_tpu.tools.convert import convert_reference_pt
from eamg_tpu.tools.gqa_recover import RecoveryConfig, run_gqa_recovery
from eamg_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

from port_harness import cfg_json, flatten, perturbed_params, run_worker

GQA_CASES = {"h8_f32": (dict(n_head=8, d_model=32), "float32", [1, 2, 4, 8]),
             "h8_bf16": (dict(n_head=8, d_model=32), "bfloat16",
                         [1, 2, 4, 8]),
             "h6_f32": (dict(n_head=6, d_model=36), "float32", [1, 2, 3, 6]),
             "h6_bf16": (dict(n_head=6, d_model=36), "bfloat16",
                         [1, 2, 3, 6])}
BASE = dict(vocab_size=30, seq_len=16, n_layer=2)
PT_CFG = dict(BASE, d_model=32, n_head=8, dtype="bfloat16")
RECOVER = dict(kv_heads=2, rows=40, steps=2, bench_iters=1)
CMDS = ["convert-gqa", "convert-pt", "export-pt", "gqa-recover"]
DEVICE_CMDS = {"gqa-recover"}
RTOL_PPL = 1e-4


_PT_READS: dict = {}


@contextlib.contextmanager
def _pt_reads_once():
    """JAX's .pt reader, memoised by path inside the block: it starts a
    subprocess for every read (torch stays out of this process), and the
    tests read each file more than once. The files are written once, in
    the fixture."""
    real = import_torch._torch_load_as_numpy

    def read(path):
        if str(path) not in _PT_READS:
            _PT_READS[str(path)] = real(path)
        return _PT_READS[str(path)]

    with mock.patch.object(import_torch, "_torch_load_as_numpy", read):
        yield


def _bf16(tree):
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                        tree)


def _jax_cli(argv) -> tuple:
    buf = io.StringIO()
    code = 0
    argv0 = list(sys.argv)
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            code = jax_cli(argv)
        except SystemExit as e:
            code = e.code
        finally:
            sys.argv = argv0
    return code, buf.getvalue()


def _flags(help_text: str) -> set:
    return set(re.findall(r"(?<![\w-])--[a-z][a-z-]*", help_text))


def _same_checkpoint(a: dict, b: dict) -> None:
    la, lb = (flatten(c["params"], "p") for c in (a, b))
    assert set(la) == set(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    assert a["cfg"] == b["cfg"]
    assert a["vocab"] == b["vocab"] and a["step"] == b["step"]
    assert a["extra"] == b["extra"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("convert")
    rng = np.random.default_rng(0)
    inp, ref = {}, {}
    # convert_mha_to_gqa
    inp["gqa/cases"] = np.asarray(json.dumps(list(GQA_CASES)))
    f32 = {}
    for name, (geo, dt, kvs) in GQA_CASES.items():
        cfg = GPTConfig(**BASE, **geo, dtype=dt)
        # a bf16 case holds its f32 twin's weights rounded
        if dt == "bfloat16":
            params = _bf16(f32[geo["n_head"]])
        else:
            params = f32[geo["n_head"]] = perturbed_params(cfg, rng, key=3)
        ref[f"gqa/{name}"] = (cfg, params, kvs)
        inp[f"gqa/{name}/cfg"] = cfg_json(cfg)
        inp.update(flatten(params, f"gqa/{name}/p"))
        inp[f"gqa/{name}/kv"] = np.asarray(json.dumps(kvs))
    f32cfg, f32p, _ = ref["gqa/h8_f32"]
    inp["gqa/f32/cfg"] = cfg_json(f32cfg)
    inp.update(flatten(f32p, "gqa/f32/p"))
    # a bf16 MHA checkpoint directory with a step, a key and extra fields
    cfg, params, _ = ref["gqa/h8_bf16"]
    src = tmp / "mha"
    save_checkpoint(str(src), params, {f"t{i}": i for i in range(30)}, cfg,
                    step=7, rng_key=np.asarray([1, 2], np.uint32),
                    extra={"preset": "large2"})
    inp["gqa_dir/src"] = np.asarray(str(src))
    inp["gqa_dir/dst"] = np.asarray(str(tmp / "port_gqa"))
    inp["gqa_dir/kv"] = np.asarray(2)
    # the .pt dialects
    pcfg = GPTConfig(**PT_CFG)
    pparams = ref["gqa/h8_bf16"][1]
    vocab = {f"t{i}": i for i in range(30)}
    ref["pt"] = (pcfg, pparams, vocab)
    inp["pt/cfg"] = cfg_json(pcfg)
    inp.update(flatten(pparams, "pt/p"))
    inp["pt/vocab"] = np.asarray(json.dumps(vocab))
    inp["pt/tmp"] = np.asarray(str(tmp))
    inp.update(flatten(jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(1), GPTConfig(**dict(PT_CFG, n_experts=2)))),
        "pt/moe_p"))
    inp.update(flatten(jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(1), GPTConfig(**dict(PT_CFG, n_kv_heads=2)))),
        "pt/gqa_p"))
    # convert-pt reads JAX's kv-dialect file and the port's trainer-dialect
    # one (the port writes it first; test_export_pt_gives_jaxs_keys_and_
    # arrays holds it to JAX's)
    convert = {}
    export_reference_checkpoint(str(tmp / "jax_kv.pt"), pparams, vocab,
                                pcfg, dialect="kv")
    for dialect in ("trainer", "kv"):
        pt = tmp / ("jax_kv.pt" if dialect == "kv" else "port_trainer.pt")
        for serving in (False, True):
            name = f"{dialect}_{int(serving)}"
            convert[name] = [str(pt), str(tmp / f"port_conv_{name}"),
                             serving]
    inp["pt/convert"] = np.asarray(json.dumps(convert))
    ref["pt/convert"] = convert
    # gqa-recover on a small Scheme-B3 checkpoint
    rcfg = GPTConfig(vocab_size=len(SchemeB3(seq_len=32).vocab), seq_len=32,
                     d_model=32, n_head=4, n_layer=1, causal=True)
    rsrc = tmp / "b3_small"
    b3vocab = SchemeB3(seq_len=32).vocab.tok2id
    save_checkpoint(str(rsrc), jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(2), rcfg)), b3vocab, rcfg)
    ref["recover/src"] = str(rsrc)
    ref["recover/jax"] = run_gqa_recovery(RecoveryConfig(
        ckpt_dir=str(rsrc), log_fn=lambda *_: None, **RECOVER))
    inp["recover/kw"] = np.asarray(json.dumps(dict(RECOVER,
                                                   ckpt_dir=str(rsrc))))
    # the CLI
    inp["cli/cmds"] = np.asarray(json.dumps(CMDS))
    runs = {"convert-gqa": ["convert-gqa", "--ckpt", str(src), "--out",
                            str(tmp / "cli_port_gqa"), "--kv-heads", "4"],
            "convert-pt": ["convert-pt", "--pt", str(tmp / "jax_kv.pt"),
                           "--out", str(tmp / "cli_port_conv"),
                           "--serving-arch"],
            "export-pt": ["export-pt", "--ckpt", str(tmp / "jax_recover_ck"),
                          "--pt", str(tmp / "cli_port.pt")],
            "gqa-recover": ["gqa-recover", "--ckpt", str(rsrc), "--rows",
                            "40", "--steps", "2", "--device", "cpu"]}
    # a causal checkpoint for export-pt's warnings
    save_checkpoint(str(tmp / "jax_recover_ck"), pparams, vocab,
                    dataclasses.replace(pcfg, causal=True))
    inp["cli/runs"] = np.asarray(json.dumps(runs))
    # JAX's export-pt writes its .pt before the worker runs, which holds
    # the two files against each other (torch stays out of this process)
    ref["cli/export-pt"] = _jax_cli(["export-pt", "--ckpt",
                                     str(tmp / "jax_recover_ck"), "--pt",
                                     str(tmp / "cli_jax.pt")])
    inp["cli/pt_pair"] = np.asarray(json.dumps([str(tmp / "cli_port.pt"),
                                                str(tmp / "cli_jax.pt")]))
    got = run_worker("convert", inp, tmp, timeout=900)
    return got, ref, tmp


# --------------------------------------------------------------- convert-gqa

@pytest.mark.parametrize("name", list(GQA_CASES))
def test_convert_mha_to_gqa_bit_equal(results, name):
    got, ref, _ = results
    cfg, params, kvs = ref[f"gqa/{name}"]
    for kv in kvs:
        want_p, want_cfg = convert_mha_to_gqa(params, cfg, kv)
        want = flatten(want_p, f"gqa/{name}/{kv}/p")
        assert set(want) == {k for k in got
                             if k.startswith(f"gqa/{name}/{kv}/p/")}
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert int(got[f"gqa/{name}/{kv}/n_kv_heads"]) == \
            want_cfg.n_kv_heads == kv
    assert str(got[f"gqa/{name}/refuse/divisor"]).startswith("ValueError")


def test_convert_refuses_a_gqa_source(results):
    got, _, _ = results
    assert str(got["gqa_dir/refuse/gqa"]).startswith(
        "ValueError: source must be MHA")


def test_converted_directory_loads_in_jax(results):
    got, ref, tmp = results
    convert_checkpoint_dir(str(tmp / "mha"), str(tmp / "jax_gqa"), 2)
    port, want = (load_checkpoint(str(tmp / d))
                  for d in ("port_gqa", "jax_gqa"))
    _same_checkpoint(port, want)
    assert port["opt_state"] is None
    np.testing.assert_array_equal(port["rng_key"], want["rng_key"])
    assert port["extra"]["gqa_converted_from"] == "mha-8h"
    assert port["cfg"].n_kv_heads == 2


# ----------------------------------------------------------- .pt in and out

@pytest.mark.parametrize("dialect", ["trainer", "kv"])
def test_export_pt_gives_jaxs_keys_and_arrays(results, dialect):
    got, ref, tmp = results
    cfg, params, vocab = ref["pt"]
    want_sd = export_state_dict(params, dialect)
    assert json.loads(str(got[f"pt/{dialect}/keys"])) == sorted(want_sd)
    path = str(tmp / f"port_{dialect}.pt")
    if dialect == "kv":
        with _pt_reads_once():
            raw = import_torch._torch_load_as_numpy(path)
        assert set(raw["model"]) == set(want_sd)
        for k, w in want_sd.items():
            assert raw["model"][k].dtype == np.float32, k
            np.testing.assert_array_equal(raw["model"][k],
                                          np.asarray(w).astype(np.float32))
        assert raw["vocab"] == vocab
        assert raw["cfg"] == {"vocab_size": 30, "seq_len": 16,
                              "d_model": 32, "n_head": 8, "n_layer": 2,
                              "d_ff": 128}
        return
    # JAX's loader reads the port's file (its values are the source's cast
    # to f32); the port reads it back the same
    with _pt_reads_once():
        jp, jcfg, jvocab = load_reference_checkpoint(path)
    src = flatten(params, "s")
    for k, w in flatten(jax.tree.map(np.asarray, jp), "s").items():
        np.testing.assert_array_equal(w, src[k].astype(np.float32)
                                      if src[k].dtype != np.uint16 else
                                      (src[k].astype(np.uint32) << 16)
                                      .view(np.float32), err_msg=k)
    want = flatten(jax.tree.map(np.asarray, jp), f"pt/{dialect}/back")
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert json.loads(str(got[f"pt/{dialect}/back_cfg"])) == \
        dataclasses.asdict(jcfg)
    assert bool(got[f"pt/{dialect}/back_vocab"]) and jvocab.tok2id == vocab


@pytest.mark.parametrize("name", ["moe", "int8", "gqa"])
def test_export_refusals(results, name):
    got, _, _ = results
    assert str(got[f"pt/refuse/{name}"]).startswith("ValueError")


@pytest.mark.parametrize("name", ["trainer_0", "trainer_1", "kv_0", "kv_1"])
def test_convert_pt_gives_jaxs_checkpoint(results, name):
    _, ref, tmp = results
    pt, dst, serving = ref["pt/convert"][name]
    with _pt_reads_once():
        convert_reference_pt(pt, str(tmp / f"jax_conv_{name}"),
                             serving_arch=serving)
    port, want = load_checkpoint(dst), load_checkpoint(
        str(tmp / f"jax_conv_{name}"))
    _same_checkpoint(port, want)
    assert port["cfg"].ln_placement == ("pre" if serving else "post")


# --------------------------------------------------------------- gqa-recover

def test_gqa_recovery_equals_jax(results):
    got, ref, _ = results
    res = json.loads(str(got["recover/result"]))
    want = ref["recover/jax"]
    assert set(res) == set(want)
    assert res["kv_heads"] == want["kv_heads"] == 2
    assert res["uptrain_steps"] == want["uptrain_steps"] == 2
    for k in ("ppl_mha", "ppl_converted", "ppl_recovered"):
        np.testing.assert_allclose(res[k], want[k], rtol=RTOL_PPL, err_msg=k)
    for k in ("decode_tok_s_mha", "decode_tok_s_gqa", "speedup"):
        assert res[k] > 0, k


# ----------------------------------------------------------------------- CLI

@pytest.mark.parametrize("cmd", CMDS)
def test_subcommand_help_has_jax_flags(results, cmd):
    got, _, _ = results
    code, text = _jax_cli([cmd, "--help"])
    assert code == 0 and int(got[f"cli/help/{cmd}/code"]) == 0
    extra = {"--device"} if cmd in DEVICE_CMDS else set()
    assert _flags(str(got[f"cli/help/{cmd}/text"])) == _flags(text) | extra


@pytest.mark.parametrize("cmd", ["convert-gqa", "convert-pt", "export-pt"])
def test_subcommand_output_equals_jax(results, cmd):
    got, ref, tmp = results
    argv = {"convert-gqa": ["convert-gqa", "--ckpt", str(tmp / "mha"),
                            "--out", str(tmp / "cli_jax_gqa"),
                            "--kv-heads", "4"],
            "convert-pt": ["convert-pt", "--pt", str(tmp / "jax_kv.pt"),
                           "--out", str(tmp / "cli_jax_conv"),
                           "--serving-arch"]}.get(cmd)
    with _pt_reads_once():
        code, text = _jax_cli(argv) if argv else ref["cli/export-pt"]
    assert code in (0, None) and int(got[f"cli/run/{cmd}/code"]) == 0
    port = str(got[f"cli/run/{cmd}/stdout"])
    assert port.replace("cli_port", "cli_jax") == text
    if cmd == "export-pt":
        assert "causal=True" in text
        assert str(got["cli/pt_equal"]) == "equal"
    else:
        out = "cli_port_gqa" if cmd == "convert-gqa" else "cli_port_conv"
        _same_checkpoint(load_checkpoint(str(tmp / out)), load_checkpoint(
            str(tmp / out.replace("port", "jax"))))


def test_gqa_recover_cli_prints_jaxs_result(results):
    got, ref, _ = results
    assert int(got["cli/run/gqa-recover/code"]) == 0
    lines = str(got["cli/run/gqa-recover/stdout"]).splitlines()
    res = json.loads(lines[-1])
    assert any(ln.startswith("[gqa] MHA (4 KV heads): PPL") for ln in lines)
    want = ref["recover/jax"]   # the same rows, steps and seed
    assert set(res) == set(want)
    for k in ("ppl_mha", "ppl_converted", "ppl_recovered"):
        np.testing.assert_allclose(res[k], want[k], rtol=RTOL_PPL, err_msg=k)
