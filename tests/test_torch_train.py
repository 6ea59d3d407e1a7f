"""The port's training step against the JAX package, on the CPU.

Same inputs (numpy, from a seed) and the same weights go through the JAX
package here and through ``eamg_tpu_torch`` in one subprocess
(tests/torch_port_worker.py, task ``train``); torch never enters this
process. Sizes are small: d32, 4 heads, 2 layers, T 31, V 48.

Checked, with the tolerance and its reason:
- the host data functions (``batches``, ``pad_and_shift``, ``pack_rows``,
  ``packed_batches``, ``write_synthetic_csv`` / ``iter_csv_tokens``,
  ``encode_corpus`` and ``encode_corpus_csv`` for schemes a, b1, b2, b3):
  equal to JAX's, element for element (the shuffle is
  ``random.Random(seed)``'s on both sides);
- ``init_params`` from the same threefry key: every uniform leaf
  bit-equal; the N(0, 1) ``tok_emb`` within ERF_INV_ULPS ulps (XLA:CPU's
  log1p inside ``erf_inv`` rounds elsewhere than the port's);
- ``loss_fn`` (and the packed and chunked losses) and every gradient leaf
  against ``jax.value_and_grad``, one parametrised test over LOSS_CASES:
  f32 loss within 1e-5 relative and every leaf within 1e-5 x max|g| over
  all leaves (sums in another order); bf16 loss within 5e-3 relative and
  the whole gradient within 2e-2 relative L2 (bf16 rounds at 2^-8);
- three ``Trainer`` steps for each of TRAINER_CASES (a constant rate;
  accumulation of 2 with an all-PAD micro-batch; the ``paper`` recipe
  with its clip at 0.9, so that it fires on some steps and not on others;
  warmup + cosine) against JAX's ``Trainer``: losses
  within 1e-5 relative, the learning rates equal to optax's schedule
  values, params within 1e-5 but for the K rows of each ``in_b``: a key
  bias shifts every score of a query alike, so its gradient is zero in
  exact arithmetic and Adam turns the rounding residue into steps of up
  to the learning rate; those rows are held to 2 x the summed rate;
- a checkpoint the port saves (f32 with its optimizer state, and a bf16
  copy) loads in JAX's ``load_checkpoint`` with the same arrays, config,
  step and vocabulary; a checkpoint JAX saves with its optax state loads
  in the port, and 2 more steps equal JAX's 2 more steps (as above);
- an ``attn_block`` checkpoint served through the port's ``forward``
  (K1's plain version) against JAX's blockwise ``forward``: 1e-5.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.models.gpt import GPTConfig, forward, init_params
from eamg_tpu.train import data
from eamg_tpu.train.run import encode_corpus, encode_corpus_csv
from eamg_tpu.train.trainer import (TrainConfig, Trainer, loss_fn,
                                    loss_fn_chunked, loss_fn_packed,
                                    make_optimizer, reference_preset)
from eamg_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

from port_harness import cfg_json, flatten, perturbed_params, run_worker

V, T, B = 48, 31, 4
BASE = dict(vocab_size=V, seq_len=T + 1, d_model=32, n_head=4, n_layer=2)
LOSS_CASES = {
    "post_ln_reference": (dict(), None),
    "batch_first_bug": (dict(batch_first_bug=True), None),
    "pre_ln_gelu": (dict(ln_placement="pre", activation="gelu"), None),
    "causal_gqa2": (dict(causal=True, n_kv_heads=2), None),
    "packed_seg": (dict(causal=True), "seg"),
    "attn_block": (dict(causal=True, attn_block=8), None),
    "chunked_ce": (dict(causal=True), 7),          # T 31, not a multiple
    "bf16": (dict(causal=True, dtype="bfloat16"), None),
}
F32_LOSS_RTOL, F32_GRAD_TOL = 1e-5, 1e-5
BF16_LOSS_RTOL, BF16_GRAD_RL2 = 5e-3, 2e-2
ERF_INV_ULPS = 3
TRAINER_CASES = {
    "constant": TrainConfig(micro_batch=4),
    "accum2_all_pad": TrainConfig(micro_batch=2, accum_steps=2),
    # the paper recipe, its clip at 0.9: at this size the global norm is
    # 0.75-0.97, so the clip fires on some steps and not on others
    "paper": dataclasses.replace(reference_preset("paper"), micro_batch=4,
                                 clip_norm=0.9),
    "warmup_cosine": TrainConfig(micro_batch=4, schedule="warmup_cosine",
                                 warmup_steps=2, total_steps=6),
}
STEPS = 3
TRAIN_LOSS_RTOL, TRAIN_PARAM_TOL = 1e-5, 1e-5
BLOCK_TOL = 1e-5


def _rows(rng, n, lo=3, hi=T + 1):
    """n id rows of random lengths in [lo, hi), PAD (0) never inside."""
    return [rng.integers(1, V, rng.integers(lo, hi)).tolist()
            for _ in range(n)]


def _padded(rng, n):
    """[n, T+1] rows padded with PAD -> (x, y) shifted by one."""
    full = np.zeros((n, T + 1), np.int32)
    for i, r in enumerate(_rows(rng, n, lo=T // 2)):
        full[i, :len(r)] = r
    return full[:, :-1], full[:, 1:]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_paths(tree, prefix):
    return flatten(_np_tree(tree), prefix)


# ------------------------------------------------------------------ inputs

def _data_inputs(rng, tmp, inp, ref):
    encoded = _rows(rng, 11, lo=2, hi=30)
    spec = {"encoded": encoded, "seq_len": 24, "pad": 0,
            "batches": {"drop": dict(micro_batch=3, accum_steps=1,
                                     drop_last=True, shuffle_seed=None),
                        "keep_shuffled": dict(micro_batch=3, accum_steps=2,
                                              drop_last=False,
                                              shuffle_seed=5)},
            "packed": {"drop": dict(micro_batch=2, accum_steps=1,
                                    drop_last=True, shuffle_seed=None),
                       "keep_shuffled": dict(micro_batch=2, accum_steps=2,
                                             drop_last=False,
                                             shuffle_seed=3)},
            "csv_rows": 6, "csv_seed": 1, "csv_max_rows": 4,
            "corpus_seq_len": 40}
    for name, kw in spec["batches"].items():
        got = list(data.batches(encoded, 24, 0, **kw))
        ref[("batches", name, "x")] = np.stack([x for x, _ in got])
        ref[("batches", name, "y")] = np.stack([y for _, y in got])
    for name, kw in spec["packed"].items():
        got = list(data.packed_batches(encoded, 24, 0, **kw))
        for i, part in enumerate("xys"):
            ref[("packed", name, part)] = np.stack([b[i] for b in got])
    shifted = [data.pad_and_shift(r, 24, 0) for r in encoded]
    ref["shift_x"] = np.stack([x for x, _ in shifted])
    ref["shift_y"] = np.stack([y for _, y in shifted])
    ref["pack_rows"], ref["pack_segs"] = data.pack_rows(encoded, 24, 0)
    csv_jax = tmp / "jax.csv"
    data.write_synthetic_csv(str(csv_jax), 6, seed=1)
    ref["csv_bytes"] = csv_jax.read_bytes()
    ref["csv_tokens"] = list(data.iter_csv_tokens(str(csv_jax), max_rows=4))
    rows = data.synthetic_corpus(5, seed=2)
    for scheme in ("a", "b1", "b2", "b3"):
        enc, vocab = encode_corpus(rows, scheme, 40)
        ref[("corpus", scheme)] = ([list(map(int, r)) for r in enc],
                                   vocab.tok2id)
        enc, vocab = encode_corpus_csv(str(csv_jax), scheme, 40, max_rows=5)
        ref[("csv", scheme)] = ([list(map(int, r)) for r in enc],
                                vocab.tok2id)
    inp["data/spec"] = np.asarray(json.dumps(spec))
    inp["data/csv"] = np.asarray(str(tmp / "port.csv"))
    inp["data/corpus"] = np.asarray(json.dumps(rows))


def _jax_loss(cfg, params, x, y, seg, chunk):
    if chunk:
        def f(p):
            return loss_fn_chunked(p, x, y, cfg, 0, chunk)
    elif seg is not None:
        def f(p):
            return loss_fn_packed(p, x, y, seg, cfg, 0)
    else:
        def f(p):
            return loss_fn(p, x, y, cfg, 0)
    (loss, count), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        params)
    return float(loss), int(count), grads


def _loss_inputs(rng, inp, ref):
    inp["loss/cases"] = np.asarray(json.dumps(list(LOSS_CASES)))
    for i, (name, (kw, extra)) in enumerate(LOSS_CASES.items()):
        cfg = GPTConfig(**BASE, **kw)
        params = perturbed_params(cfg, rng, key=11 + i)
        seg = None
        if extra == "seg":
            songs = _rows(rng, 12, lo=3, hi=14)
            x, y, seg = next(data.packed_batches(songs, T + 1, 0, B))
            x, y, seg = x[0], y[0], seg[0]
        else:
            x, y = _padded(rng, B)
        chunk = extra if isinstance(extra, int) else None
        p = f"loss/{name}"
        inp.update(flatten(params, f"{p}/p"))
        inp[f"{p}/cfg"] = cfg_json(cfg)
        inp[f"{p}/spec"] = np.asarray(json.dumps({"chunk": chunk}))
        inp[f"{p}/x"], inp[f"{p}/y"] = x, y
        if seg is not None:
            inp[f"{p}/seg"] = seg
        loss, count, grads = _jax_loss(cfg, jax.tree.map(jnp.asarray, params),
                                       jnp.asarray(x), jnp.asarray(y),
                                       None if seg is None
                                       else jnp.asarray(seg), chunk)
        ref[(name, "loss")], ref[(name, "count")] = loss, count
        ref[(name, "grads")] = _leaf_paths(grads, f"{p}/grad")


def _trainer_batches(rng, name, tcfg):
    A, M = tcfg.accum_steps, tcfg.micro_batch
    xs = np.zeros((STEPS, A, M, T), np.int32)
    ys = np.zeros((STEPS, A, M, T), np.int32)
    for s in range(STEPS):
        for a in range(A):
            if name == "accum2_all_pad" and a == 1 and s < 2:
                continue                      # an all-PAD micro-batch
            xs[s, a], ys[s, a] = _padded(rng, M)
    return xs, ys


def _schedule_values(tcfg):
    if tcfg.schedule == "warmup_cosine":
        sched = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=tcfg.lr,
            warmup_steps=max(tcfg.warmup_steps, 1),
            decay_steps=tcfg.total_steps or 100_000)
        return [float(np.float32(sched(c))) for c in range(STEPS)]
    return [float(np.float32(tcfg.lr))] * STEPS


def _trainer_inputs(rng, inp, ref):
    cfg = GPTConfig(**BASE, causal=True)
    inp["trainer/cases"] = np.asarray(json.dumps(list(TRAINER_CASES)))
    for i, (name, tcfg) in enumerate(TRAINER_CASES.items()):
        p = f"trainer/{name}"
        params = perturbed_params(cfg, rng, key=31 + i)
        xs, ys = _trainer_batches(rng, name, tcfg)
        inp.update(flatten(params, f"{p}/p"))
        inp[f"{p}/cfg"] = cfg_json(cfg)
        inp[f"{p}/tcfg"] = np.asarray(json.dumps(dataclasses.asdict(tcfg)))
        inp[f"{p}/x"], inp[f"{p}/y"] = xs, ys
        t = Trainer(cfg, tcfg, params)
        ms = [t.train_step(xs[s], ys[s]) for s in range(STEPS)]
        ref[(name, "loss")] = [m["loss"] for m in ms]
        ref[(name, "tokens")] = [m["tokens"] for m in ms]
        ref[(name, "lr")] = _schedule_values(tcfg)
        ref[(name, "params")] = _leaf_paths(t.params, f"{p}/params")
        ref[(name, "cfg")] = cfg


def _checkpoint_inputs(rng, tmp, inp, ref):
    inits = {"mha": GPTConfig(**BASE), "gqa2": GPTConfig(**BASE,
                                                          n_kv_heads=2)}
    inp["init/cases"] = np.asarray(json.dumps(list(inits)))
    for i, (name, cfg) in enumerate(inits.items()):
        inp[f"init/{name}/cfg"] = cfg_json(cfg)
        inp[f"init/{name}/seed"] = np.asarray(5 + i)
        ref[("init", name)] = _leaf_paths(
            init_params(jax.random.PRNGKey(5 + i), cfg), f"init/{name}/p")

    cfg = GPTConfig(**BASE, causal=True)
    tcfg = TrainConfig(micro_batch=4)
    vocab = {f"t{i}": i for i in range(V)}
    xs, ys = _trainer_batches(rng, "ckpt", tcfg)
    inp["ckpt/cfg"] = cfg_json(cfg)
    inp["ckpt/tcfg"] = np.asarray(json.dumps(dataclasses.asdict(tcfg)))
    inp["ckpt/vocab"] = np.asarray(json.dumps(vocab))
    inp["ckpt/x"], inp["ckpt/y"] = xs, ys
    for d in ("port_dir", "port_bf16_dir", "jax_dir"):
        inp[f"ckpt/{d}"] = np.asarray(str(tmp / d))
    t = Trainer(cfg, tcfg, perturbed_params(cfg, rng, key=41))
    t.train_step(xs[0], ys[0])
    save_checkpoint(str(tmp / "jax_dir"), t.params, vocab, cfg,
                    opt_state=t.opt_state, step=t.step)
    ref["resume_loss"] = [t.train_step(xs[i], ys[i])["loss"] for i in (1, 2)]
    ref["resume_params"] = _leaf_paths(t.params, "ckpt/resume/params")
    ref["ckpt_cfg"], ref["ckpt_vocab"] = cfg, vocab

    bcfg = GPTConfig(**BASE, causal=True, attn_block=8)
    params = perturbed_params(bcfg, rng, key=51)
    ids = rng.integers(0, V, (2, T)).astype(np.int32)
    inp.update(flatten(params, "block/p"))
    inp["block/cfg"], inp["block/ids"] = cfg_json(bcfg), ids
    ref["block_logits"] = np.asarray(forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(ids), bcfg))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(1414)
    tmp = tmp_path_factory.mktemp("train")
    inp, ref = {}, {}
    _data_inputs(rng, tmp, inp, ref)
    _loss_inputs(rng, inp, ref)
    _trainer_inputs(rng, inp, ref)
    _checkpoint_inputs(rng, tmp, inp, ref)
    got = run_worker("train", inp, tmp, timeout=600)
    return got, ref, tmp


# ------------------------------------------------------------------- data

@pytest.mark.parametrize("name", ["drop", "keep_shuffled"])
def test_batches_equal_jax(results, name):
    got, ref, _ = results
    for part in "xy":
        np.testing.assert_array_equal(got[f"data/batches/{name}/{part}"],
                                      ref[("batches", name, part)])


@pytest.mark.parametrize("name", ["drop", "keep_shuffled"])
def test_packed_batches_equal_jax(results, name):
    got, ref, _ = results
    for part in "xys":
        np.testing.assert_array_equal(got[f"data/packed/{name}/{part}"],
                                      ref[("packed", name, part)])


def test_pad_and_shift_and_pack_rows_equal_jax(results):
    got, ref, _ = results
    np.testing.assert_array_equal(got["data/shift/x"], ref["shift_x"])
    np.testing.assert_array_equal(got["data/shift/y"], ref["shift_y"])
    np.testing.assert_array_equal(got["data/pack/rows"], ref["pack_rows"])
    np.testing.assert_array_equal(got["data/pack/segs"], ref["pack_segs"])


def test_synthetic_csv_and_its_stream_equal_jax(results):
    got, ref, _ = results
    assert got["data/csv_bytes"].tobytes() == ref["csv_bytes"]
    assert json.loads(str(got["data/csv_tokens"])) == ref["csv_tokens"]


@pytest.mark.parametrize("source", ["corpus", "csv"])
@pytest.mark.parametrize("scheme", ["a", "b1", "b2", "b3"])
def test_encode_corpus_equal_jax(results, source, scheme):
    got, ref, _ = results
    ids, vocab = ref[(source, scheme)]
    assert json.loads(str(got[f"data/{source}/{scheme}/ids"])) == ids
    assert json.loads(str(got[f"data/{source}/{scheme}/vocab"])) == vocab


# ------------------------------------------------------------------- init

@pytest.mark.parametrize("name", ["mha", "gqa2"])
def test_init_params_from_the_same_key_equal_jax(results, name):
    got, ref, _ = results
    want = ref[("init", name)]
    assert set(k for k in got if k.startswith(f"init/{name}/p/")) \
        == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k.endswith("/tok_emb"):
            ulps = np.abs(g.view(np.int32).astype(np.int64)
                          - w.view(np.int32).astype(np.int64))
            assert ulps.max() <= ERF_INV_ULPS, (k, ulps.max())
            assert (ulps > 0).mean() < 0.02, (ulps > 0).mean()
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# ------------------------------------------------------------- loss, grad

@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_loss_and_grads_match_jax(results, name):
    got, ref, _ = results
    p = f"loss/{name}"
    assert int(got[f"{p}/count"]) == ref[(name, "count")]
    loss, want = float(got[f"{p}/loss"]), ref[(name, "loss")]
    grads = ref[(name, "grads")]
    assert set(k for k in got if k.startswith(f"{p}/grad/")) == set(grads)
    bf16 = LOSS_CASES[name][0].get("dtype") == "bfloat16"
    if bf16:
        assert abs(loss - want) <= BF16_LOSS_RTOL * abs(want)
        g = np.concatenate([got[k].ravel() for k in grads])
        w = np.concatenate([grads[k].ravel() for k in grads])
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= BF16_GRAD_RL2, rel
        return
    assert abs(loss - want) <= F32_LOSS_RTOL * abs(want), (loss, want)
    scale = max(np.abs(w).max() for w in grads.values())
    for k, w in grads.items():
        assert got[k].shape == w.shape, k
        err = np.abs(got[k] - w).max()
        assert err <= F32_GRAD_TOL * scale, (k, err, scale)


# ----------------------------------------------------------------- trainer

def _k_bias_split(cfg, key):
    """The slice of an in_b leaf that holds its K rows, else None."""
    if key.endswith("/attn/in_b"):
        return slice(cfg.d_model, cfg.d_model + cfg.kv_dim)
    return None


def _assert_params_close(cfg, got, want, lr_sum):
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        ks = _k_bias_split(cfg, k)
        if ks is None:
            np.testing.assert_allclose(g, w, rtol=0, atol=TRAIN_PARAM_TOL,
                                       err_msg=k)
            continue
        rest = np.ones(w.shape, bool)
        rest[ks] = False
        np.testing.assert_allclose(g[rest], w[rest], rtol=0,
                                   atol=TRAIN_PARAM_TOL, err_msg=k)
        assert np.abs(g[ks] - w[ks]).max() <= 2 * lr_sum, k


@pytest.mark.parametrize("name", list(TRAINER_CASES))
def test_trainer_steps_match_jax(results, name):
    got, ref, _ = results
    p = f"trainer/{name}"
    np.testing.assert_allclose(got[f"{p}/loss"], ref[(name, "loss")],
                               rtol=TRAIN_LOSS_RTOL, atol=0)
    assert list(got[f"{p}/lr"]) == ref[(name, "lr")]
    _assert_params_close(ref[(name, "cfg")],
                         {k: got[k] for k in ref[(name, "params")]},
                         ref[(name, "params")], sum(ref[(name, "lr")]))
    if name == "paper":
        norms = got[f"{p}/grad_norm"]
        assert (norms >= 0.9).any() and (norms < 0.9).any(), norms
    # the step's non-PAD targets (an all-PAD micro-batch adds 1, as JAX
    # counts it: its loss clamps the count at 1)
    assert list(got[f"{p}/tokens"]) == ref[(name, "tokens")]


# -------------------------------------------------------------- checkpoint

def test_port_checkpoint_loads_in_jax(results):
    got, ref, tmp = results
    ck = load_checkpoint(str(tmp / "port_dir"))
    assert ck["cfg"] == ref["ckpt_cfg"]
    assert ck["vocab"] == ref["ckpt_vocab"] and ck["step"] == 1
    assert ck["extra"] == {"preset": "test"}
    want = _leaf_paths(ck["params"], "ckpt/port_params")
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    # the optimizer state is the tree JAX's make_optimizer builds
    opt = ck["opt_state"]
    like = make_optimizer(TrainConfig(micro_batch=4)).init(ck["params"])
    assert jax.tree.structure(opt) == jax.tree.structure(like)
    adam = opt[0][0]
    mu = _leaf_paths(adam.mu, "ckpt/port_mu")
    for k, w in mu.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert int(adam.count) == 1 and adam.count.dtype == np.int32


def test_port_bf16_checkpoint_loads_in_jax_as_bf16(results):
    got, _, tmp = results
    ck = load_checkpoint(str(tmp / "port_bf16_dir"))
    leaves = jax.tree_util.tree_flatten_with_path(ck["params"])[0]
    assert len(leaves) == len([k for k in got
                               if k.startswith("ckpt/port_params/")])
    for path, w in leaves:
        k = "ckpt/port_params" + "".join(
            f"/{getattr(e, 'key', getattr(e, 'idx', e))}" for e in path)
        assert w.dtype == jnp.bfloat16, k
        # the f32 params rounded to bf16 by the port, read back by JAX
        np.testing.assert_array_equal(
            np.asarray(w, np.float32),
            np.asarray(jnp.asarray(got[k]).astype(jnp.bfloat16)
                       .astype(jnp.float32)), err_msg=k)


def test_jax_checkpoint_resumes_in_the_port(results):
    got, ref, _ = results
    assert int(got["ckpt/resume/step0"]) == 1
    assert int(got["ckpt/resume/count0"]) == 1
    np.testing.assert_allclose(got["ckpt/resume/loss"], ref["resume_loss"],
                               rtol=TRAIN_LOSS_RTOL, atol=0)
    lr = float(np.float32(TrainConfig().lr))
    _assert_params_close(ref["ckpt_cfg"],
                         {k: got[k] for k in ref["resume_params"]},
                         ref["resume_params"], 3 * lr)


def test_attn_block_checkpoint_served_through_k1_plain(results):
    got, ref, _ = results
    np.testing.assert_allclose(got["block/logits"], ref["block_logits"],
                               rtol=BLOCK_TOL, atol=BLOCK_TOL)
