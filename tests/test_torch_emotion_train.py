"""The port's emotion training against the JAX package on the CPU: the
training forward of eamg_tpu_torch/models/distilbert.py, the losses and
steps of emotion/train_scratch.py, emotion/finetune.py and the
finetune-emotion subcommand.

The torch side runs in one subprocess (tests/torch_port_emotion.py, task
"emotion_train"). JAX's losses are train_scratch.py's own (its step
functions are local to its loops, so their loss_fn bodies are restated
here: :216-243 for the classifier, :139-147 for MLM). Tolerances:
- forward (pool cls, mean and max; without LoRA and with an active one),
  forward_token_logits and forward_hidden: f32 within F32_TOL of jitted
  JAX;
- the losses (pool max with cue suppression 0.3 and without, pool cls,
  MLM through the tied embedding): within F32_TOL relative, every
  gradient leaf within F32_TOL x max|g| over all leaves (sums in another
  order), the heads' zero MLM gradient included;
- three optimizer steps of each trainer: the classifier (pool max, cue
  suppression, warmup 2 + cosine to 6) and MLM (warmup 1 + cosine):
  losses within F32_TOL relative, params within F32_TOL. LoRA on the
  shipped classifier (max_length 128 over its 64 positions: JAX's gather
  clamps the positions past the table), cast to f32: losses within
  F32_TOL relative, the moments within F32_TOL, the trainable leaves
  under the Adam rule (_AdamGap: all but ADAM_SHARE of the entries within
  F32_TOL, every one within twice the summed rate, since Adam moves an
  entry whose gradient is rounding residue by up to the rate). On its
  float16 pickle as the CLI hands it over: every leaf and moment of JAX's
  dtype (heads and their moments f16, LoRA f32); the first step's loss
  within F32_TOL relative, the same head entries gone inf or NaN (f16
  Adam: the epsilon rounds to 0 and (1 - b2) g^2 underflows), the finite
  f16 entries within F16_ULPS ulps and the f32 ones under the Adam rule;
  from the second step on a NaN loss and NaN LoRA factors in both, and
  heads non-finite in both (but for the few entries JAX's NaN propagation
  leaves finite);
- finetune with an eval split: the history within F32_TOL relative, the
  merged tree within F32_TOL, the caller's tree unchanged;
- finetune-emotion on the shipped f16 classifier (one step): JAX's step
  line, the final JSON's loss within F32_TOL relative, and a params.pkl
  of JAX's dtype per leaf, compared as the first LoRA step is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from eamg_tpu.cli import main as jax_cli
from eamg_tpu.emotion.distill_data import make_corpus
from eamg_tpu.emotion.finetune import (LoraSpec, finetune, init_lora,
                                       make_finetune_step)
from eamg_tpu.emotion.train_scratch import ScratchSpec
from eamg_tpu.models import distilbert as db

from port_harness import REPO, cfg_json, flatten, run_worker

F32_TOL = 1e-5
F16_ULPS = 1
ADAM_SHARE = 5e-3
PACKAGED = REPO / "eamg_tpu" / "emotion" / "ckpt_distilbert"
SMALL = db.DistilBertConfig(vocab_size=50, max_position_embeddings=16,
                            dim=32, n_layers=2, n_heads=4, hidden_dim=64)
POOLS = ("cls", "mean", "max")
LOSS_CASES = {"max_suppress": ("max", 0.3), "max": ("max", 0.0),
              "cls": ("cls", 0.0), "mlm": ("max", 0.0)}
STEPS_SPEC = dict(lr=1e-3, batch=4, label_smoothing=0.05, pool="max",
                  cue_suppress=0.3)
SCHEDULES = {"classifier": (2, 6), "mlm": (1, 6)}
LOOP_SPEC = dict(r=4, alpha=8.0, batch=8, epochs=2, lr=5e-3, seed=0,
                 max_length=12)
FT_ROWS, FT_BATCH = 3, 8
B, T = 4, 12


def _params(rng):
    """JAX's init at SMALL with every bias and LayerNorm made to matter."""
    params = jax.tree.map(np.asarray, db.init_params(jax.random.PRNGKey(1),
                                                     SMALL))

    def perturb(node, path=""):
        if isinstance(node, dict):
            return {k: perturb(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v, path) for v in node]
        if path.endswith("/g"):
            return (1 + 0.1 * rng.standard_normal(node.shape)).astype(
                np.float32)
        if path.endswith("/b"):
            return (0.1 * rng.standard_normal(node.shape)).astype(np.float32)
        return node

    return perturb(params)


def _batch(rng, vocab=SMALL.vocab_size, t=T, b=B):
    ids = rng.integers(5, vocab, (b, t)).astype(np.int32)
    lens = rng.integers(1, t + 1, b)
    lens[0] = t
    mask = (np.arange(t)[None] < lens[:, None]).astype(np.int32)
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    cue = ((rng.random((b, t)) < 0.3) & (mask > 0)).astype(np.int32)
    labels = rng.integers(0, 28, b).astype(np.int32)
    lm = ((rng.random((b, t)) < 0.3) & (mask > 0)).astype(np.float32)
    corrupted = np.where(lm > 0, 4, ids).astype(np.int32)
    return {"ids": ids, "mask": mask, "labels": labels, "cue": cue,
            "targets": ids, "lm": lm, "corrupted": corrupted}


# ---------------------------------------------- JAX's losses, restated

def _jax_classifier_loss(p, ids, mask, labels, cue_mask, cfg, sm, suppress):
    neutral_id = 27
    if suppress:
        tok = db.forward_token_logits(p, ids, mask, cfg)
        neg = jnp.finfo(tok.dtype).min
        logits = jnp.max(jnp.where(mask[..., None] > 0, tok, neg), axis=1)
    else:
        logits = db.forward(p, ids, mask, cfg)
    logp = jax.nn.log_softmax(logits, axis=-1)
    onehot = jax.nn.one_hot(labels, cfg.num_labels)
    target = onehot * (1 - sm) + sm / cfg.num_labels
    loss = -jnp.mean(jnp.sum(target * logp, axis=-1))
    if suppress:
        non_cue = (mask > 0) & (cue_mask == 0)
        cls_w = jnp.ones((cfg.num_labels,)).at[neutral_id].set(0.0)
        pen = jnp.square(jax.nn.relu(tok)) * cls_w
        pen = jnp.sum(pen * non_cue[..., None]) / \
            jnp.maximum(jnp.sum(non_cue), 1)
        loss = loss + suppress * pen
    return loss


def _jax_mlm_loss(p, ids, mask, targets, loss_mask, cfg):
    h = db.forward_hidden(p, ids, mask, cfg)
    logits = h @ p["word_emb"].T
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None], axis=-1)[..., 0]
    return jnp.sum(nll * loss_mask) / jnp.maximum(jnp.sum(loss_mask), 1.0)


def _cfg(pool):
    return dataclasses.replace(SMALL, pool=pool)


def _loss_fn(case):
    pool, suppress = LOSS_CASES[case]
    cfg = _cfg(pool)
    if case == "mlm":
        return lambda p, b: _jax_mlm_loss(p, b["corrupted"], b["mask"],
                                          b["targets"], b["lm"], cfg)
    return lambda p, b: _jax_classifier_loss(
        p, b["ids"], b["mask"], b["labels"], b["cue"], cfg, 0.05, suppress)


def _shipped():
    with open(PACKAGED / "config.pkl", "rb") as f:
        cfg = db.DistilBertConfig(**pickle.load(f))
    with open(PACKAGED / "params.pkl", "rb") as f:
        return cfg, pickle.load(f)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("emotion_train")
    rng = np.random.default_rng(0)
    inp = {}
    params = _params(rng)
    inp.update(flatten(params, "fw/params"))
    lora = jax.tree.map(np.asarray, init_lora(jax.random.PRNGKey(3), SMALL,
                                              LoraSpec(r=4)))
    for lp in lora["layers"]:
        for name in ("q", "v"):
            lp[name]["B"] = (0.1 * rng.standard_normal(
                lp[name]["B"].shape)).astype(np.float32)
    inp.update(flatten(lora, "fw/lora"))
    fw = _batch(rng)
    inp["fw/ids"], inp["fw/mask"] = fw["ids"], fw["mask"]
    for pool in POOLS:
        inp[f"fw/cfg/{pool}"] = cfg_json(_cfg(pool))
    loss_b = _batch(rng)
    for k in ("mask", "labels", "cue", "targets", "lm"):
        inp[f"loss/{k}"] = loss_b[k]
    inp["loss/ids"] = loss_b["ids"]
    inp["loss/cases"] = np.asarray(json.dumps(LOSS_CASES))
    # the MLM case reads the corrupted ids
    inp["loss/ids_mlm"] = loss_b["corrupted"]
    step_b = [_batch(rng) for _ in range(3)]
    for i, b in enumerate(step_b):
        for k in ("mask", "labels", "cue", "targets", "lm"):
            inp[f"steps/{i}/{k}"] = b[k]
        inp[f"steps/{i}/ids"] = b["ids"]
        inp[f"steps/{i}/ids_mlm"] = b["corrupted"]
    inp["steps/spec"] = np.asarray(json.dumps(STEPS_SPEC))
    inp["steps/schedules"] = np.asarray(json.dumps(SCHEDULES))
    # LoRA steps on the shipped classifier, the CLI's max_length of 128
    cfg, _ = _shipped()
    tok = db.WordPieceTokenizer(str(PACKAGED / "vocab.txt"))
    corpus = make_corpus(n_per_label=4, seed=1)
    texts, labels = corpus["eval"]
    texts = texts[:FT_ROWS * FT_BATCH - 1] + [" ".join(texts[:12])]
    ft = []
    for i in range(FT_ROWS):
        sel = slice(i * FT_BATCH, (i + 1) * FT_BATCH)
        enc = [tok.encode(t, LoraSpec().max_length) for t in texts[sel]]
        ft.append({"ids": np.stack([e["input_ids"] for e in enc]),
                   "mask": np.stack([e["attention_mask"] for e in enc]),
                   "labels": np.asarray(labels[sel], np.int32)})
        for k, v in ft[-1].items():
            inp[f"ft/{i}/{k}"] = v
    # the finetune loop on SMALL, with a vocabulary of SMALL's size
    words = [f"w{i}" for i in range(SMALL.vocab_size - 5)]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words
    loop_texts = [" ".join(rng.choice(words, rng.integers(1, 9)))
                  for _ in range(40)]
    loop_labels = [int(x) for x in rng.integers(0, 4, 40)]
    inp["loop/cfg"] = cfg_json(SMALL)
    inp["loop/vocab"] = np.asarray(json.dumps(vocab))
    inp["loop/spec"] = np.asarray(json.dumps(LOOP_SPEC))
    inp["loop/texts"] = np.asarray(json.dumps(loop_texts))
    inp["loop/labels"] = np.asarray(json.dumps(loop_labels))
    # finetune-emotion on the shipped classifier: one epoch of one step
    # (the f16 heads go non-finite in that step; see the LoRA steps test)
    tsv = tmp / "rows.tsv"
    tsv.write_text("".join(f"{t}\t{l}\n" for t, l in
                           zip(corpus["eval"][0][:16],
                               corpus["eval"][1][:16])))
    paths = {"tsv": str(tsv), "port": str(tmp / "ft_port"),
             "jax": str(tmp / "ft_jax")}
    inp["ftcli/paths"] = np.asarray(json.dumps(paths))
    got = run_worker("emotion_train", inp, tmp, timeout=900)
    ref = {"params": params, "lora": lora, "fw": fw, "loss": loss_b,
           "steps": step_b, "ft": ft, "loop": (vocab, loop_texts,
                                               loop_labels),
           "paths": paths}
    return got, ref


# ---------------------------------------------------------------- forward

@pytest.mark.parametrize("with_lora", [False, True], ids=["plain", "lora"])
@pytest.mark.parametrize("pool", POOLS)
def test_forward_matches_jax(results, pool, with_lora):
    got, ref = results
    kw = dict(lora=ref["lora"], lora_scale=2.0) if with_lora else {}
    want = db.forward(ref["params"], jnp.asarray(ref["fw"]["ids"]),
                      jnp.asarray(ref["fw"]["mask"]), _cfg(pool), **kw)
    name = "lora" if with_lora else "plain"
    np.testing.assert_allclose(got[f"fw/{pool}/{name}"], np.asarray(want),
                               atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("fn", ["token_logits", "hidden"])
def test_token_logits_and_hidden_match_jax(results, fn):
    got, ref = results
    f = db.forward_token_logits if fn == "token_logits" else \
        db.forward_hidden
    want = jax.jit(f, static_argnums=3)(
        ref["params"], jnp.asarray(ref["fw"]["ids"]),
        jnp.asarray(ref["fw"]["mask"]), _cfg("max"))
    np.testing.assert_allclose(got[f"fw/{fn}"], np.asarray(want),
                               atol=F32_TOL, rtol=0)


# ----------------------------------------------------------- loss, grads

@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_loss_and_grads_match_jax(results, case):
    got, ref = results
    fn = _loss_fn(case)
    loss, grads = jax.jit(jax.value_and_grad(fn))(ref["params"], ref["loss"])
    np.testing.assert_allclose(got[f"loss/{case}/loss"], np.asarray(loss),
                               rtol=F32_TOL)
    want = flatten(jax.tree.map(np.asarray, grads), f"loss/{case}/grad")
    scale = max(np.abs(w).max() for w in want.values())
    assert sorted(k for k in got if k.startswith(f"loss/{case}/grad/")) \
        == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=F32_TOL * scale, rtol=0,
                                   err_msg=k)


# ----------------------------------------------------------------- steps

def _jax_scratch_steps(name):
    spec = ScratchSpec(**STEPS_SPEC)
    warmup, total = SCHEDULES[name]
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, spec.lr, warmup_steps=warmup, decay_steps=total),
        weight_decay=spec.weight_decay)
    fn = _loss_fn("max_suppress" if name == "classifier" else "mlm")

    @jax.jit
    def step(p, s, b):
        loss, g = jax.value_and_grad(fn)(p, b)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    return opt, step


@pytest.mark.parametrize("name", ["classifier", "mlm"])
def test_three_scratch_steps_match_jax(results, name):
    got, ref = results
    opt, step = _jax_scratch_steps(name)
    p = ref["params"]
    s = opt.init(p)
    losses = []
    for b in ref["steps"]:
        p, s, loss = step(p, s, b)
        losses.append(float(loss))
    np.testing.assert_allclose(got[f"steps/{name}/losses"], losses,
                               rtol=F32_TOL)
    for k, w in flatten(jax.tree.map(np.asarray, p),
                        f"steps/{name}/params").items():
        np.testing.assert_allclose(got[k], w, atol=F32_TOL, rtol=0,
                                   err_msg=k)


def _f16_order(x):
    i = x.view(np.int16).astype(np.int32)
    return np.where(i < 0, -(i & 0x7FFF), i)


class _AdamGap:
    """Adam's step is about g / |g| where |g| nears its epsilon of 1e-8, so
    an f32 entry whose gradient is rounding residue (the LoRA B factors of
    the last layers hold some) moves by up to the rate either way: all but
    ADAM_SHARE of the f32 entries within F32_TOL, every one within twice
    the summed rate. The share is of every entry compared, the f16 ones
    (held to F16_ULPS) included."""

    def __init__(self, lr_sum):
        self.lr_sum, self.off, self.n = lr_sum, 0, 0

    def add(self, g, w, key):
        gap = np.abs(g - w)
        assert gap.max() <= 2 * self.lr_sum, (key, gap.max())
        self.off += int((gap > F32_TOL).sum())
        self.n += gap.size

    def check(self):
        assert self.off <= ADAM_SHARE * self.n, (self.off, self.n)


def _compare(g, w, key, gap: _AdamGap):
    """Equal dtypes and non-finite entries; the finite f16 ones within
    F16_ULPS ulps, the finite f32 ones under the Adam rule."""
    assert g.dtype == w.dtype, (key, g.dtype, w.dtype)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=key)
    np.testing.assert_array_equal(g[np.isinf(g)], w[np.isinf(w)],
                                  err_msg=key)
    fin = np.isfinite(w)
    if w.dtype == np.float16:
        ulps = np.abs(_f16_order(g[fin]) - _f16_order(w[fin]))
        assert ulps.size == 0 or ulps.max() <= F16_ULPS, (key, ulps.max())
        gap.n += w.size
    elif fin.any():
        gap.add(g[fin], w[fin], key)


def _lora_run(base):
    """JAX's make_finetune_step for three steps on the shipped classifier
    -> [(loss, trainable)] and the moments."""
    cfg, raw = _shipped()
    frozen = raw if base == "f16" else jax.tree.map(
        lambda a: np.asarray(a, np.float32), raw)
    spec = LoraSpec()
    trainable = {"lora": init_lora(jax.random.PRNGKey(spec.seed), cfg, spec),
                 "pre_classifier": frozen["pre_classifier"],
                 "classifier": frozen["classifier"]}
    step, opt = make_finetune_step(cfg, spec)
    state = opt.init(trainable)
    return trainable, state, step, frozen


@pytest.mark.parametrize("base", ["f32", "f16"])
def test_three_lora_steps_match_jax(results, base):
    """On the f32 base every step is compared. On the f16 base the first
    step is (every head entry that goes inf or NaN, and the rest); from
    the second on the loss is NaN in both and so is every LoRA factor,
    while the heads are non-finite in both but for a few entries that
    JAX's NaN propagation through the masked max leaves finite (2 of the
    28 classifier biases and a fifth of the pre_classifier ones here):
    those are not compared."""
    got, ref = results
    trainable, state, step, frozen = _lora_run(base)
    gap = _AdamGap(3 * LoraSpec().lr)
    for i, b in enumerate(ref["ft"]):
        trainable, state, m = step(trainable, frozen, state,
                                   *(jnp.asarray(b[k]) for k in
                                     ("ids", "mask", "labels")))
        g_loss, w_loss = float(got[f"ft/{base}/{i}/loss"]), float(m["loss"])
        want = flatten(jax.tree.map(np.asarray, trainable),
                       f"ft/{base}/{i}/trainable")
        if i == 0 or base == "f32":
            np.testing.assert_allclose(g_loss, w_loss, rtol=F32_TOL)
            for k, w in want.items():
                _compare(got[k], w, k, gap)
            continue
        assert np.isnan(g_loss) and np.isnan(w_loss), (i, g_loss, w_loss)
        for k, w in want.items():
            assert got[k].dtype == w.dtype, k
            if "/lora/" in k:
                assert np.isnan(got[k]).all() and np.isnan(w).all(), k
            else:
                assert not np.isfinite(got[k]).all(), k
                assert not np.isfinite(w).all(), k
    moments = flatten(jax.tree.map(np.asarray, {"mu": state[0].mu,
                                                "nu": state[0].nu}),
                      f"ft/{base}/moments")
    for k, w in moments.items():
        assert got[k].dtype == w.dtype, k
        if base == "f32":
            np.testing.assert_allclose(got[k], w, atol=F32_TOL, rtol=0,
                                       err_msg=k)
    gap.check()
    if base == "f16":
        heads = got["ft/f16/0/trainable/classifier/w"]
        assert heads.dtype == np.float16 and not np.isfinite(heads).all()


def test_finetune_loop_matches_jax(results):
    got, ref = results
    vocab, texts, labels = ref["loop"]
    merged, _, history = finetune(
        ref["params"], SMALL, db.WordPieceTokenizer(vocab), texts, labels,
        spec=LoraSpec(**LOOP_SPEC), eval_fraction=0.25,
        log_fn=lambda *_: None)
    port = json.loads(str(got["loop/history"]))
    assert [sorted(h) for h in port] == [sorted(h) for h in history]
    for g, w in zip(port, history):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=k)
    for k, w in flatten(jax.tree.map(np.asarray, merged),
                        "loop/merged").items():
        np.testing.assert_allclose(got[k], w, atol=F32_TOL, rtol=0,
                                   err_msg=k)
    assert bool(got["loop/params_unchanged"])


def test_finetune_cli_on_the_f16_base_matches_jax(results):
    got, ref = results
    paths = ref["paths"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax_cli(["finetune-emotion", "--base", str(PACKAGED), "--tsv",
                 paths["tsv"], "--out", paths["jax"], "--epochs", "1",
                 "--log-every", "1"])
    assert int(got["ftcli/code"]) in (0, None)
    port_lines = str(got["ftcli/stdout"]).replace(paths["port"], "OUT") \
        .splitlines()
    jax_lines = buf.getvalue().replace(paths["jax"], "OUT").splitlines()
    # the step lines print 4 decimals; the final JSON the f32 loss whole
    assert port_lines[:-1] == jax_lines[:-1]
    port_json, jax_json = json.loads(port_lines[-1]), json.loads(jax_lines[-1])
    assert list(port_json) == list(jax_json)
    np.testing.assert_allclose(port_json["final_loss"],
                               jax_json["final_loss"], rtol=F32_TOL)
    assert port_json["out"] == jax_json["out"]
    with open(os.path.join(paths["jax"], "params.pkl"), "rb") as f:
        want = flatten(pickle.load(f), "ftcli/params")
    assert sorted(k for k in got if k.startswith("ftcli/params/")) == \
        sorted(want)
    gap = _AdamGap(LoraSpec().lr)
    for k, w in want.items():
        _compare(got[k], w, k, gap)
    gap.check()
    for name in ("config.pkl", "vocab.txt"):
        with open(os.path.join(paths["port"], name), "rb") as a, \
                open(os.path.join(paths["jax"], name), "rb") as b:
            assert a.read() == b.read(), name
