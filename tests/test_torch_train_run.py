"""The port's training runs, evaluation and CLI against the JAX package,
on the CPU.

Same inputs (numpy, from a seed) and the same weights go through the JAX
package here and through ``eamg_tpu_torch`` in one subprocess
(tests/torch_port_worker.py, task ``train_run``); torch never enters this
process.

Checked, with the tolerance and its reason:
- ``perplexity`` (10 rows in chunks of 4: a tail chunk padded with PAD
  rows), ``teacher_forced_logits`` (with and without the refeed of the
  last prompt token) on a causal GQA-2 model, f32, and ``verify_stream``
  (temperature, top-k, top-p, min-p) of one recorded stream (JAX's
  raises on more than one: its top-p threshold is [B, 1] against [B, n,
  V] logits): 1e-5 relative on the perplexity, 1e-4 on logits and
  log-probs, the support flags equal;
- ``run_training`` on the ``mini`` preset (batch_first_bug, Scheme A) and
  with ``pack`` at a cut width (d64, 64 positions), 16 synthetic songs,
  one epoch: the same summary (steps, vocabulary), the final loss within
  1e-5 relative, the same checkpoint directories; of the ``final`` params
  at least 99.9% within 1e-5 (``tok_emb`` relative: JAX's and the port's
  N(0, 1) draws differ by up to 3 ulps) and every one within 2 x the
  summed learning rate: Adam's step is ~ g / |g| wherever |g| is near its
  epsilon, so an element whose gradient is rounding residue (the K rows of
  each ``in_b``, whose gradient is zero in exact arithmetic, and a few
  others) moves by up to the learning rate on either side;
- a tiny ``train_demo_a`` (bf16, as the tool trains): the corpus, coverage
  and step counts equal JAX's; the final loss within 5e-3 relative and the
  perplexities within 2e-2 relative (bf16 rounds at 2^-8, and a
  perplexity exponentiates the loss); the obedience fractions in [0, 1];
- ``cli train --device cpu`` then the port's ``cli generate --checkpoint
  .../final`` writes MThd and RIFF....WAVE, as JAX's
  tests/test_cli_tools.py does with its own CLI; ``--mesh-data 2`` and
  ``--mesh-model 2`` on the card (the default device) of a host with no
  card exit 2 with JAX's "mesh DxM > n devices", and ``--fsdp`` with a
  mesh of one trains as one device (the mesh modes themselves:
  tests/test_torch_mesh.py; ``--experts`` trains:
  tests/test_torch_variants.py holds it to JAX);
- every kernel wrapper raises when an input requires grad while autograd
  records (on the CPU branch too), runs under ``torch.no_grad()``, and the
  serving forward with params that require grad gives the same logits;
- ``Trainer``, ``run_training`` and ``train_demo_a`` want the card when no
  device is given.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode.replay import (perplexity, teacher_forced_logits,
                                    verify_stream)
from eamg_tpu.models.gpt import GPTConfig
from eamg_tpu.tools.demo_a import DemoASpec, train_demo_a
from eamg_tpu.train.run import run_training
from eamg_tpu.utils.checkpoint import load_checkpoint

from port_harness import cfg_json, flatten, perturbed_params, run_worker

V = 40
REPLAY_CFG = GPTConfig(vocab_size=V, seq_len=24, d_model=32, n_head=4,
                       n_layer=2, causal=True, n_kv_heads=2)
REPLAY = {"batch": 4, "prompt_len": 5,
          "verify": {"temperature": 0.8, "top_k": 10, "top_p": 0.9,
                     "min_p": 0.05}}
PPL_RTOL, LOGIT_TOL = 1e-5, 1e-4
RUNS = {"mini": dict(preset="mini", synthetic_rows=16, epochs=1,
                     save_every_steps=1, seed=0,
                     geometry={"d_model": 64, "seq_len": 64}),
        "pack": dict(preset="mini", synthetic_rows=16, epochs=1,
                     save_every_steps=1, seed=1, pack=True,
                     geometry={"d_model": 64, "seq_len": 64})}
RUN_LOSS_RTOL, RUN_PARAM_TOL, RUN_CLOSE_SHARE = 1e-5, 1e-5, 0.999
DEMO = dict(rows=48, heldout_rows=12, d_model=32, n_head=4, n_layer=2,
            seq_len=64, epochs=2, micro_batch=16, gen_batch=2, max_gen=24,
            kv_heads=2)
DEMO_EXACT = ("heldout_token_coverage", "heldout_songs_in_vocab",
              "heldout_rows", "train_rows", "epochs", "steps", "corpus",
              "geometry", "note")
DEMO_LOSS_RTOL, DEMO_PPL_RTOL = 5e-3, 2e-2
_TINY = ["--preset", "mini", "--synthetic", "16", "--epochs", "1",
         "--log-every", "0", "--d-model", "64", "--seq-len", "64"]
# argv -> (exit code, what stderr says)
REFUSALS = {"mesh_data": (["train", "--mesh-data", "2", *_TINY], 2,
                          "mesh 2x1 > 0 devices"),
            "mesh_model": (["train", "--mesh-model", "2", *_TINY], 2,
                           "mesh 1x2 > 0 devices"),
            "fsdp": (["train", "--device", "cpu", "--fsdp", *_TINY], 0,
                     "")}
WRAPPERS = ("flash_attention", "fused_ffn", "flash_decode_sp",
            "flash_decode", "flash_decode_vmem", "flash_decode_fold",
            "flash_decode_fold2", "flash_decode_fold3",
            "flash_decode_fold_sp", "flash_decode_fold3_sp", "kth_value",
            "top_k_mask", "stream_reduce")


def _replay_inputs(rng, inp, ref):
    params = perturbed_params(REPLAY_CFG, rng, key=61)
    jp = jax.tree.map(jnp.asarray, params)
    ppl_ids = rng.integers(1, V, (10, 24)).astype(np.int32)
    for i in range(10):
        ppl_ids[i, rng.integers(8, 24):] = 0
    ppl_ids[9] = 0                                  # an all-PAD row
    ids = rng.integers(1, V, (2, 20)).astype(np.int32)
    inp.update(flatten(params, "replay/p"))
    inp["replay/cfg"] = cfg_json(REPLAY_CFG)
    inp["replay/spec"] = np.asarray(json.dumps(REPLAY))
    inp["replay/ppl_ids"], inp["replay/ids"] = ppl_ids, ids
    inp["replay/stream"] = ids[0]
    ref["ppl"] = perplexity(jp, REPLAY_CFG, ppl_ids, pad_id=0,
                            batch=REPLAY["batch"])
    for refeed in (True, False):
        ref[("tf", refeed)] = np.asarray(teacher_forced_logits(
            jp, jnp.asarray(ids), REPLAY["prompt_len"], REPLAY_CFG,
            refeed_last_prompt=refeed))
    ref["verify"] = verify_stream(jp, REPLAY_CFG, ids[0],
                                  REPLAY["prompt_len"], **REPLAY["verify"])


def _run_inputs(tmp, inp, ref):
    inp["run/cases"] = np.asarray(json.dumps(RUNS))
    for name, kw in RUNS.items():
        d = tmp / f"jax_run_{name}"
        lines = []
        s = run_training(out_dir=str(d), log_fn=lines.append, **kw)
        ref[("run", name)] = {k: v for k, v in s.items() if k != "out_dir"}
        ref[("run_dirs", name)] = sorted(p.name for p in d.iterdir())
        ref[("run_final", name)] = flatten(jax.tree.map(
            np.asarray, load_checkpoint(str(d / "final"))["params"]),
            f"run/{name}/final")
        ref[("run_cfg", name)] = load_checkpoint(str(d / "final"))["cfg"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(1415)
    tmp = tmp_path_factory.mktemp("train_run")
    inp, ref = {}, {}
    _replay_inputs(rng, inp, ref)
    _run_inputs(tmp, inp, ref)
    ref["demo"] = train_demo_a(str(tmp / "jax_demo"), DemoASpec(**DEMO),
                               log_fn=lambda m: None)
    inp["demo/spec"] = np.asarray(json.dumps(DEMO))
    inp["demo/dir"] = np.asarray(str(tmp / "port_demo"))
    inp["cli/refusals"] = np.asarray(json.dumps(
        {name: argv for name, (argv, _, _) in REFUSALS.items()}))
    got = run_worker("train_run", inp, tmp, timeout=600)
    return got, ref, tmp


# ------------------------------------------------------------------ replay

def test_perplexity_matches_jax(results):
    got, ref, _ = results
    assert abs(float(got["replay/ppl"]) - ref["ppl"]) <= PPL_RTOL * ref["ppl"]


@pytest.mark.parametrize("refeed", [True, False])
def test_teacher_forced_logits_match_jax(results, refeed):
    got, ref, _ = results
    want = ref[("tf", refeed)]
    assert got[f"replay/tf/{int(refeed)}"].shape == want.shape
    np.testing.assert_allclose(got[f"replay/tf/{int(refeed)}"], want,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_verify_stream_matches_jax(results):
    got, ref, _ = results
    want = ref["verify"]
    for k in ("n_tokens", "all_in_top_k"):
        assert got[f"replay/verify/{k}"].item() == want[k], k
    assert abs(float(got["replay/verify/in_top_k_fraction"])
               - want["in_top_k_fraction"]) <= 1e-6   # an f32 mean
    np.testing.assert_allclose(got["replay/verify/log_prob_per_token"],
                               want["log_prob_per_token"], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    assert abs(float(got["replay/verify/total_log_prob"])
               - want["total_log_prob"]) <= LOGIT_TOL * abs(
                   want["total_log_prob"])


# ------------------------------------------------------------ run_training

@pytest.mark.parametrize("name", list(RUNS))
def test_run_training_summary_matches_jax(results, name):
    got, ref, _ = results
    s, want = json.loads(str(got[f"run/{name}/summary"])), ref[("run", name)]
    assert s["steps"] == want["steps"] and s["vocab_size"] == \
        want["vocab_size"]
    assert abs(s["final_loss"] - want["final_loss"]) <= \
        RUN_LOSS_RTOL * abs(want["final_loss"])
    assert json.loads(str(got[f"run/{name}/dirs"])) == \
        ref[("run_dirs", name)]


@pytest.mark.parametrize("name", list(RUNS))
def test_run_training_final_params_match_jax(results, name):
    got, ref, _ = results
    bound = 2 * 3e-4 * ref[("run", name)]["steps"] * (1 + 0.01)
    close, total = 0, 0
    for k, w in ref[("run_final", name)].items():
        g = got[k]
        assert g.shape == w.shape, k
        d = np.abs(g - w)
        if k.endswith("/tok_emb"):
            d = d / np.maximum(np.abs(w), 1.0)
        assert d.max() <= bound, (k, d.max())
        close += int((d <= RUN_PARAM_TOL).sum())
        total += d.size
    assert close >= RUN_CLOSE_SHARE * total, (close, total)


# -------------------------------------------------------------------- demo

def test_train_demo_a_metrics_match_jax(results):
    got, ref, _ = results
    m, want = json.loads(str(got["demo/metrics"])), ref["demo"]
    assert set(m) == set(want)
    for k in DEMO_EXACT:
        assert m[k] == want[k], k
    assert abs(m["final_loss"] - want["final_loss"]) <= \
        DEMO_LOSS_RTOL * abs(want["final_loss"])
    for k in ("train_ppl", "heldout_ppl"):
        assert abs(m[k] - want[k]) <= DEMO_PPL_RTOL * want[k], k
    for k in ("grid_onset_obedience", "in_key_obedience"):
        assert 0.0 <= m[k] <= 1.0, k


def test_train_demo_a_checkpoint_loads_in_jax_as_bf16(results):
    _, _, tmp = results
    ck = load_checkpoint(str(tmp / "port_demo"))
    assert ck["cfg"].dtype == "bfloat16" and ck["cfg"].n_kv_heads == 2
    for leaf in jax.tree.leaves(ck["params"]):
        assert leaf.dtype == jnp.bfloat16
    assert (tmp / "port_demo" / "train_metrics.json").exists()


# --------------------------------------------------------------------- cli

def test_cli_train_then_generate(results):
    got, _, _ = results
    assert int(got["cli/train_code"]) == 0
    assert json.loads(str(got["cli/train_summary"]))["steps"] >= 1
    assert int(got["cli/generate_code"]) == 0
    assert got["cli/midi"].tobytes() == b"MThd"
    wav = got["cli/wav"].tobytes()
    assert wav[:4] == b"RIFF" and wav[8:12] == b"WAVE"


@pytest.mark.parametrize("name", list(REFUSALS))
def test_cli_train_refuses_what_is_not_in_the_port(results, name):
    got, _, _ = results
    _, code, says = REFUSALS[name]
    assert int(got[f"cli/refuse/{name}/code"]) == code
    stderr = str(got[f"cli/refuse/{name}/stderr"])
    assert says in stderr and "not yet in the PyTorch port" not in stderr


# ----------------------------------------------------------- grad refusal

@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrappers_refuse_inputs_that_require_grad(results, name):
    got, _, _ = results
    raised = str(got[f"grad/{name}/raised"])
    assert raised.startswith("RuntimeError") and "requires grad" in raised
    assert str(got[f"grad/{name}/no_grad"]) == "none"
    assert str(got[f"grad/{name}/plain"]) == "none"


def test_serving_forward_unaffected_by_params_that_require_grad(results):
    got, _, _ = results
    assert bool(got["grad/serving_forward_equal"])


@pytest.mark.parametrize("entry", ["Trainer", "run_training",
                                   "train_demo_a"])
def test_training_entry_points_want_cuda_by_default(results, entry):
    got, _, _ = results
    msg = str(got[f"default/{entry}"])
    assert msg.startswith("RuntimeError") and "device='cpu'" in msg
