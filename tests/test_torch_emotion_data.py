"""The port's emotion-training data path, converters and CLI against the
JAX package on the CPU: eamg_tpu_torch/emotion/distill_data.py,
situation_gen.py (and its frozen_exam.json), the tokenizer's training
options and init_params in models/distilbert.py, init_lora in
emotion/finetune.py, tools/publish.py, tools/convert.py, the four
emotion-training subcommands and a tiny distill_classifier.

The torch side runs in one subprocess (tests/torch_port_emotion.py, task
"emotion_data"); JAX's export and conversion, which import torch, run in
one subprocess of their own. Tolerances:
- make_corpus (the test's tiny draw and the shipped recipe's 1200 rows a
  label, seed 2026), label_banks, situation_banks, tokenizer_corpus ->
  build_wordpiece_vocab, the situation generator (generate, split_schemas,
  schema_count, build_frozen_exam, frozen_exam, generator_crosstalk):
  exactly equal; the port's frozen_exam.json is JAX's, byte for byte, under
  JAX's pinned hash;
- encode with piece dropout and cue spans, and tokenize_dropout: ids,
  masks and cue masks exactly equal, and the next draw of the shared
  random.Random equal (the same draws consumed);
- init_params from one threefry key: every zero and one leaf equal, every
  N(0, 0.02) leaf within ERF_INV_ULPS + 1 ulps (XLA:CPU's erf_inv rounds
  elsewhere, tests/test_torch_train.py; the scale by 0.02 adds one
  rounding); init_lora bit-equal;
- import_hf_state_dict of a synthetic PEFT state dict (prefixes,
  base_layer, modules_to_save, lora_A/lora_B): exactly equal;
- export-emotion-hf of the shipped classifier: pytorch_model.bin's keys,
  dtypes and values and config.json equal to JAX's export; export then
  convert-distilbert gives back every leaf exactly (as f32), by the port
  and from JAX's export alike;
- the four subcommands: --help has JAX's flags (plus --device for the two
  that train), the parsed defaults are JAX's, convert-distilbert and
  export-emotion-hf print what JAX's print (paths aside), and --push
  without huggingface_hub raises JAX's RuntimeError (no upload is tried);
- distill_classifier at tests/test_distill_emotion.py's tiny size with the
  shipped recipe's head (pool max, cue suppression 0.3) and one MLM
  epoch: the same log lines and metrics.json keys, every accuracy within
  one sentence of its split (the f32 weights differ in the last bits, so
  an argmax at a near tie may fall the other way; measured: equal), the
  params.pkl leaves f16 of JAX's structure within F16_ULPS ulps (a zero
  of either sign counting as one value); each
  package's EmotionClassifier reads the other's directory, with
  probabilities within 1e-5 of the owner's; a recipe of one epoch raises
  ValueError in both (its cosine decay has no steps).
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import pickle
import random
import re
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

import jax
import optax

from eamg_tpu import cli as jax_cli_module
from eamg_tpu.emotion import distill_data as dd
from eamg_tpu.emotion import situation_gen as sg
from eamg_tpu.emotion.finetune import LoraSpec, init_lora
from eamg_tpu.emotion.infer import EmotionClassifier
from eamg_tpu.emotion.train_scratch import ScratchSpec, distill_classifier
from eamg_tpu.models import distilbert as db

from port_harness import REPO, cfg_json, flatten, run_worker
from test_emotion_situation_gen import EXAM_SHA256

ERF_INV_ULPS = 3
F16_ULPS = 1
PACKAGED = REPO / "eamg_tpu" / "emotion" / "ckpt_distilbert"
CORPORA = {"tiny": dict(n_per_label=24, seed=0, gen_per_label=None),
           "shipped": dict(n_per_label=1200, seed=2026, gen_per_label=0)}
ENCODE_CASES = {"plain": (0.0, False, 24), "dropout": (0.5, False, 24),
                "cue": (0.0, True, 24), "cue_dropout": (0.5, True, 24),
                "cue_dropout_truncated": (0.5, True, 8)}
SMALL = db.DistilBertConfig(vocab_size=50, max_position_embeddings=16,
                            dim=32, n_layers=2, n_heads=4, hidden_dim=64)
LORA = dict(r=4, alpha=8.0)
CMDS = ("distill-emotion", "finetune-emotion", "convert-distilbert",
        "export-emotion-hf")
REQUIRED = {"distill-emotion": [],
            "finetune-emotion": ["--base", "b", "--tsv", "t", "--out", "o"],
            "convert-distilbert": ["--hf-dir", "h", "--out", "o"],
            "export-emotion-hf": ["--ckpt", "c", "--out", "o"]}
TRAINS = ("distill-emotion", "finetune-emotion")
TINY = dict(dim=32, n_layers=1, n_heads=2, hidden_dim=64, max_length=24,
            batch=32, epochs=2, n_per_label=24, pool="max", cue_suppress=0.3,
            pretrain_epochs=1)
# the neural accuracies of metrics.json and their splits
NEURAL_SPLITS = {
    "eval_acc_distilbert": "eval",
    "unseen_forms_acc_distilbert": "eval_unseen_forms",
    "ood_acc_distilbert": "ood", "ood_top3_distilbert": "ood",
    "eval_situations_acc": "eval_situations",
    "frozen_exam_acc": "frozen_exam", "frozen_exam_top3": "frozen_exam",
    "ood_implicit_acc": "ood_implicit", "ood_implicit_top3": "ood_implicit"}
SENTENCES = ["i am so happy today", "the contractor never showed, i am "
             "fuming", "thank you so much for the help", "meh"]

_JAX_EXPORT = r"""
import contextlib, io, json, sys
sys.path.insert(0, {repo!r})
from eamg_tpu.cli import main
paths = json.loads({paths!r})
out = {{}}
for name, argv in (("export", ["export-emotion-hf", "--ckpt", {ckpt!r},
                               "--out", paths["jax_hf"]]),
                   ("convert", ["convert-distilbert", "--hf-dir",
                                paths["jax_hf"], "--out",
                                paths["jax_back"]])):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out[name] = buf.getvalue()
sys.modules["huggingface_hub"] = None
try:
    main(["export-emotion-hf", "--ckpt", {ckpt!r}, "--out",
          paths["jax_push"], "--push", "a/b"])
    out["push"] = "none"
except Exception as e:
    out["push"] = f"{{type(e).__name__}}: {{e}}"
print(json.dumps(out))
"""


def _jax_export(paths: dict) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run(
        [sys.executable, "-c", _JAX_EXPORT.format(
            repo=str(REPO), paths=json.dumps(paths), ckpt=str(PACKAGED))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _jax_cli(argv) -> tuple:
    buf = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            code = jax_cli_module.main(argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


def _jax_defaults(cmd: str) -> dict:
    fn = "cmd_" + cmd.replace("-", "_")
    seen = {}
    with mock.patch.object(jax_cli_module, fn,
                           lambda a: seen.update(vars(a))):
        jax_cli_module.main([cmd] + REQUIRED[cmd])
    seen.pop("fn")
    return seen


def _peft_state_dict(rng) -> dict:
    """An HF sequence classifier of SMALL with a PEFT LoRA adapter on
    q_lin and v_lin and saved heads, as numpy arrays."""
    params = jax.tree.map(np.asarray, db.init_params(jax.random.PRNGKey(2),
                                                     SMALL))
    sd = {}

    def put(name, a):
        sd[name] = (a + 0.01 * rng.standard_normal(a.shape)).astype(
            np.float32)

    pre = "base_model.model."
    put(pre + "distilbert.embeddings.word_embeddings.weight",
        params["word_emb"])
    put(pre + "distilbert.embeddings.position_embeddings.weight",
        params["pos_emb"])
    put(pre + "distilbert.embeddings.LayerNorm.weight",
        params["emb_ln"]["g"])
    put(pre + "distilbert.embeddings.LayerNorm.bias", params["emb_ln"]["b"])
    for i, p in enumerate(params["layers"]):
        lay = f"{pre}distilbert.transformer.layer.{i}"
        for src, dst in (("q", "attention.q_lin"), ("k", "attention.k_lin"),
                         ("v", "attention.v_lin"),
                         ("out", "attention.out_lin"), ("lin1", "ffn.lin1"),
                         ("lin2", "ffn.lin2")):
            wrap = ".base_layer" if src in ("q", "v") else ""
            put(f"{lay}.{dst}{wrap}.weight", p[src]["w"])
            put(f"{lay}.{dst}{wrap}.bias", p[src]["b"])
            if src in ("q", "v"):
                put(f"{lay}.{dst}.lora_A.default.weight",
                    np.zeros((8, SMALL.dim), np.float32))
                put(f"{lay}.{dst}.lora_B.default.weight",
                    np.zeros((SMALL.dim, 8), np.float32))
        for ln, dst in (("sa_ln", "sa_layer_norm"),
                        ("out_ln", "output_layer_norm")):
            put(f"{lay}.{dst}.weight", p[ln]["g"])
            put(f"{lay}.{dst}.bias", p[ln]["b"])
    for head in ("pre_classifier", "classifier"):
        for wrap in ("original_module", "modules_to_save.default"):
            put(f"{pre}{head}.{wrap}.weight", params[head]["w"])
            put(f"{pre}{head}.{wrap}.bias", params[head]["b"])
    return sd


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("emotion_data")
    rng = np.random.default_rng(0)
    inp, ref = {}, {}
    # corpus, vocabulary, generator
    inp["data/corpora"] = np.asarray(json.dumps(CORPORA))
    for name, kw in CORPORA.items():
        data = dd.make_corpus(**kw)
        ref[f"corpus/{name}"] = json.dumps(data)
        ref[f"vocab/{name}"] = dd.build_wordpiece_vocab(
            dd.tokenizer_corpus(data["train"][0]))
        if name == "tiny":
            tiny = data
    # encode: train sentences with their cue spans, and a long one
    vocab = ref["vocab/tiny"]
    texts = tiny["train"][0][:60] + [" ".join(tiny["train"][0][:6])]
    cues = tiny["train_cues"][:60] + [tiny["train_cues"][0]]
    inp["enc/vocab"] = np.asarray(json.dumps(vocab))
    inp["enc/texts"] = np.asarray(json.dumps(texts))
    inp["enc/cues"] = np.asarray(json.dumps(cues))
    inp["enc/cases"] = np.asarray(json.dumps(ENCODE_CASES))
    ref["enc"] = (vocab, texts, cues)
    # init
    inp["init/cfg"] = cfg_json(SMALL)
    inp["init/lora_spec"] = np.asarray(json.dumps(LORA))
    # converters
    inp["hf/cfg"] = cfg_json(SMALL)
    sd = _peft_state_dict(rng)
    for k, v in sd.items():
        inp[f"hf/sd/{k}"] = v
    ref["hf/sd"] = sd
    paths = {k: str(tmp / k) for k in ("port_hf", "port_back", "jax_hf",
                                       "jax_back", "port_from_jax",
                                       "push_hf", "jax_push")}
    inp["hf/paths"] = np.asarray(json.dumps(paths))
    ref["jax_export"] = _jax_export(paths)
    # CLI
    inp["cli/cmds"] = np.asarray(json.dumps(CMDS))
    inp["cli/required"] = np.asarray(json.dumps(REQUIRED))
    inp["cli/runs"] = np.asarray(json.dumps({
        "export": ["export-emotion-hf", "--ckpt", str(PACKAGED), "--out",
                   paths["port_hf"]],
        "convert": ["convert-distilbert", "--hf-dir", paths["port_hf"],
                    "--out", paths["port_back"]]}))
    # a tiny distill_classifier on each side
    dirs = {"port": str(tmp / "distill_port"),
            "jax": str(tmp / "distill_jax")}
    lines = []
    ref["distill/metrics"] = distill_classifier(
        dirs["jax"], spec=ScratchSpec(**TINY), log_fn=lines.append)
    ref["distill/log"] = lines[:-1]
    inp["distill/dirs"] = np.asarray(json.dumps(dirs))
    inp["distill/spec"] = np.asarray(json.dumps(TINY))
    inp["distill/texts"] = np.asarray(json.dumps(SENTENCES))
    got = run_worker("emotion_data", inp, tmp, timeout=900)
    return got, ref, paths, dirs


# ----------------------------------------------------------- corpus, exam

@pytest.mark.parametrize("name", list(CORPORA))
def test_corpus_equal(results, name):
    got, ref, _, _ = results
    assert str(got[f"data/corpus/{name}"]) == ref[f"corpus/{name}"]


@pytest.mark.parametrize("name", list(CORPORA))
def test_wordpiece_vocab_equal(results, name):
    got, ref, _, _ = results
    assert json.loads(str(got[f"data/vocab/{name}"])) == ref[f"vocab/{name}"]


def test_banks_equal(results):
    got, _, _, _ = results
    assert json.loads(str(got["data/label_banks"])) == dd.label_banks()
    assert json.loads(str(got["data/situation_banks"])) == \
        dd.situation_banks()


def test_frozen_exam_is_jax_bytes(results):
    got, _, _, _ = results
    data = got["data/exam_bytes"].tobytes()
    assert hashlib.sha256(data).hexdigest() == EXAM_SHA256
    with open(sg._EXAM_PATH, "rb") as f:
        assert data == f.read()


def test_situation_generator_equal(results):
    got, _, _, _ = results
    gen = json.loads(str(got["data/generator"]))
    want = {"frozen_exam": sg.frozen_exam(),
            "built_exam": sg.build_frozen_exam(),
            "crosstalk": sg.generator_crosstalk()}
    for label in sorted(sg.SCHEMAS):
        for split in ("train", "eval"):
            rng = random.Random(5)
            want[f"{label}/{split}/generate"] = sg.generate(label, rng, 12,
                                                            split)
            want[f"{label}/{split}/next"] = rng.random()
            want[f"{label}/{split}/schemas"] = sg.split_schemas(label, split)
            want[f"{label}/{split}/count"] = sg.schema_count(label, split)
    assert gen == json.loads(json.dumps(want))


# ---------------------------------------------------------------- encode

@pytest.mark.parametrize("case", list(ENCODE_CASES))
def test_encode_equal_with_the_same_draws(results, case):
    got, ref, _, _ = results
    vocab, texts, cues = ref["enc"]
    tok = db.WordPieceTokenizer(vocab)
    p, with_cue, max_length = ENCODE_CASES[case]
    rng = random.Random(11)
    encs = [tok.encode(t, max_length, rng=rng, piece_dropout=p,
                       cue=cues[i] if with_cue else None)
            for i, t in enumerate(texts)]
    keys = sorted(encs[0])
    assert keys == sorted(k.split("/")[-1] for k in got
                          if k.startswith(f"enc/{case}/")
                          and not k.endswith("/next"))
    for k in keys:
        np.testing.assert_array_equal(got[f"enc/{case}/{k}"],
                                      np.stack([e[k] for e in encs]),
                                      err_msg=k)
    assert float(got[f"enc/{case}/next"]) == rng.random()


def test_tokenize_dropout_equal(results):
    got, ref, _, _ = results
    vocab, texts, _ = ref["enc"]
    tok = db.WordPieceTokenizer(vocab)
    rng = random.Random(3)
    assert json.loads(str(got["enc/dropout_tokens"])) == [
        tok.tokenize_dropout(t, rng, 0.5) for t in texts]
    assert float(got["enc/dropout_next"]) == rng.random()


# ------------------------------------------------------------------ init

def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_init_params_bit_equal(results):
    got, _, _, _ = results
    want = flatten(jax.tree.map(np.asarray, db.init_params(
        jax.random.PRNGKey(5), SMALL)), "init/params")
    assert sorted(k for k in got if k.startswith("init/params/")) == \
        sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if np.all((w == 0) | (w == 1)):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert _ulps(g, w).max() <= ERF_INV_ULPS + 1, \
                (k, _ulps(g, w).max())


def test_init_lora_bit_equal(results):
    got, _, _, _ = results
    want = flatten(jax.tree.map(np.asarray, init_lora(
        jax.random.PRNGKey(9), SMALL, LoraSpec(**LORA))), "init/lora")
    assert sorted(k for k in got if k.startswith("init/lora/")) == \
        sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


# ------------------------------------------------------------ converters

def test_import_hf_state_dict_equal(results):
    got, ref, _, _ = results
    want = flatten(db.import_hf_state_dict(ref["hf/sd"], SMALL),
                   "hf/imported")
    assert sorted(k for k in got if k.startswith("hf/imported/")) == \
        sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype == np.float32, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_export_equals_jax_export(results):
    got, _, paths, _ = results
    assert str(got["hf/bin_equal"]) == "equal"
    assert int(got["hf/n_keys"]) == 8 + 16 * 4
    for name in ("config.json", "vocab.txt"):
        with open(os.path.join(paths["port_hf"], name), "rb") as a, \
                open(os.path.join(paths["jax_hf"], name), "rb") as b:
            assert a.read() == b.read(), name


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("src", ["port_back", "port_from_jax"])
def test_export_then_convert_gives_back_every_leaf(results, src):
    _, _, paths, _ = results
    shipped = _load(PACKAGED / "params.pkl")
    back = _load(os.path.join(paths[src], "params.pkl"))
    jax_back = _load(os.path.join(paths["jax_back"], "params.pkl"))
    s_leaves, treedef = jax.tree.flatten(shipped)
    b_leaves, b_def = jax.tree.flatten(back)
    assert b_def == treedef and jax.tree.structure(jax_back) == treedef
    for s, b, j in zip(s_leaves, b_leaves, jax.tree.leaves(jax_back)):
        assert b.dtype == j.dtype == np.float32
        np.testing.assert_array_equal(b, np.asarray(s, np.float32))
        np.testing.assert_array_equal(b, j)
    assert _load(os.path.join(paths[src], "config.pkl")) == \
        _load(os.path.join(paths["jax_back"], "config.pkl"))


# ------------------------------------------------------------------- CLI

def _flags(help_text: str) -> set:
    return set(re.findall(r"(?<![\w-])--[a-z][a-z-]*", help_text))


@pytest.mark.parametrize("cmd", CMDS)
def test_subcommand_help_has_jax_flags(results, cmd):
    got, _, _, _ = results
    code, text = _jax_cli([cmd, "--help"])
    assert code == 0 and int(got[f"cli/help/{cmd}/code"]) == 0
    extra = {"--device"} if cmd in TRAINS else set()
    assert _flags(str(got[f"cli/help/{cmd}/text"])) == _flags(text) | extra


@pytest.mark.parametrize("cmd", CMDS)
def test_subcommand_defaults_are_jax(results, cmd):
    got, _, _, _ = results
    port = json.loads(str(got[f"cli/defaults/{cmd}"]))
    if cmd in TRAINS:
        assert port.pop("device") is None
    assert port == _jax_defaults(cmd)


def test_cli_prints_what_jax_prints(results):
    got, ref, paths, _ = results
    jax_out = ref["jax_export"]
    for name, (mine, theirs) in {
            "export": ("port_hf", "jax_hf"),
            "convert": ("port_back", "jax_back")}.items():
        assert int(got[f"cli/run/{name}/code"]) in (0, None)
        text = str(got[f"cli/run/{name}/stdout"])
        assert text.replace(paths[mine], "OUT") == \
            jax_out[name].replace(paths[theirs], "OUT")


def test_push_without_hub_raises_jax_error(results):
    got, ref, _, _ = results
    assert str(got["cli/push_raised"]) == ref["jax_export"]["push"] == \
        "RuntimeError: huggingface_hub is not installed"


# ------------------------------------------------------- distill, end to end

def test_distill_log_and_metrics(results):
    got, ref, _, dirs = results
    want = ref["distill/metrics"]
    metrics = json.loads(str(got["distill/metrics"]))
    assert list(metrics) == list(want)
    with open(os.path.join(dirs["port"], "metrics.json")) as f:
        on_disk = json.load(f)
    with open(os.path.join(dirs["jax"], "metrics.json")) as f:
        assert list(on_disk) == list(json.load(f))
    data = dd.make_corpus(n_per_label=TINY["n_per_label"], seed=42,
                          gen_per_label=0)
    sizes = {k: len(data[split][0]) for k, split in NEURAL_SPLITS.items()}
    sizes.update(dict.fromkeys(("ood_acc_56_r2_metric",
                                "ood_top3_56_r2_metric"), len(dd.OOD_EVAL)))
    for k, w in want.items():
        g = metrics[k]
        if k == "train_seconds":
            continue
        if isinstance(w, float) and w != w:
            assert g is None and on_disk[k] is None, k
        elif k in sizes:
            assert abs(g - w) <= 1 / sizes[k] + 1e-4, (k, g, w)
        else:
            assert g == w, (k, g, w)
    assert json.loads(str(got["distill/log"])) == ref["distill/log"]


def test_distill_params_pickle_is_jax_tree(results):
    _, _, _, dirs = results
    port = _load(os.path.join(dirs["port"], "params.pkl"))
    want = _load(os.path.join(dirs["jax"], "params.pkl"))
    assert jax.tree.structure(port) == jax.tree.structure(want)
    assert list(port) == list(want)
    for a, b in zip(jax.tree.leaves(port), jax.tree.leaves(want)):
        assert type(a) is np.ndarray and a.dtype == b.dtype == np.float16
        ulps = np.abs(_f16_order(a) - _f16_order(b))
        assert ulps.max() <= F16_ULPS, ulps.max()
    for name in ("config.pkl", "vocab.txt"):
        with open(os.path.join(dirs["port"], name), "rb") as a, \
                open(os.path.join(dirs["jax"], name), "rb") as b:
            assert a.read() == b.read(), name


def _f16_order(x):
    """f16 values -> integers in their order, one apart for neighbours;
    +0 and -0 are one value (a zero bias decayed by XLA and by the port
    may keep either sign)."""
    i = x.view(np.int16).astype(np.int32)
    return np.where(i < 0, -(i & 0x7FFF), i)


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_classifiers_read_each_others_dirs(results, reader):
    got, _, _, dirs = results
    if reader == "port":       # the port reading JAX's dir, against JAX
        clf = EmotionClassifier(backend="distilbert",
                                checkpoint_dir=dirs["jax"])
        want = np.stack([clf._probs(t) for t in SENTENCES])
        np.testing.assert_allclose(got["distill/probs/jax"], want,
                                   atol=1e-5)
    else:                      # JAX reading the port's dir, against the port
        clf = EmotionClassifier(backend="distilbert",
                                checkpoint_dir=dirs["port"])
        have = np.stack([clf._probs(t) for t in SENTENCES])
        np.testing.assert_allclose(have, got["distill/probs/port"],
                                   atol=1e-5)


def test_one_epoch_recipe_raises_in_both(results):
    got, _, _, _ = results
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup_steps=5,
                                           decay_steps=5)
    assert str(got["distill/one_epoch"]).startswith("ValueError")
