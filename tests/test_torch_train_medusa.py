"""Training Medusa heads in the port against the JAX package, on the CPU;
the port's ``train-medusa`` and ``medusa-measure`` commands; ``GET
/profile``.

A small corrected causal Scheme-A checkpoint (the demo vocabulary, L2,
d32) is written here by the JAX package; JAX trains heads on it here and
the port in one subprocess (tests/torch_port_worker.py, task
``train_medusa``), from the same seed and rows.

Checked, with the tolerance and its reason:
- the head loss (JAX's: the gathered NLL of the token 1 + k ahead over
  every head's valid positions) of random heads on one batch within 1e-5
  relative of JAX's formula on ``eamg_tpu``'s ``forward_hidden``, and one
  AdamW step of optax's defaults from it: the heads within 1e-6 of
  optax's (f32 sums in another order; Adam's step is about the learning
  rate 1e-3 a parameter, its direction the gradient's sign);
- ``train_medusa_heads`` for 2 epochs of 2 steps: the logged epoch losses
  within 1e-4 and the final loss within 1e-5 relative of JAX's run, the
  trained heads within 2e-5 (four such steps), and the probe's rates
  within 1e-3 (its rounded rates; a near-tie argmax may move one);
- the pickle the port writes loads in JAX's ``load_medusa_heads`` with
  JAX's keys, shapes and dtypes;
- ``cli train-medusa --measure`` and ``medusa-measure`` (linear and
  ``--tree``) exit 0 and print JAX's JSON keys;
- ``GET /profile`` on a CPU pipeline answers 200 with ``trace_dir`` and
  ``view``, at ``?dir=`` and at a new directory, each holding a Chrome
  trace with events.
"""

from __future__ import annotations

import json
import pickle

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax

from eamg_tpu.models.gpt import GPTConfig, forward_hidden, init_params
from eamg_tpu.serve.pipeline import demo_pipeline
from eamg_tpu.tools.medusa import (MedusaSpec, load_medusa_heads,
                                  train_medusa_heads)
from eamg_tpu.train.data import pad_rows
from eamg_tpu.utils.checkpoint import save_checkpoint

from port_harness import cfg_json, flatten, run_worker

SEQ = 64
SPEC = dict(n_heads=2, rows=16, epochs=2, batch=8, lr=1e-3, seed=0)
LOSS_RTOL, STEP_ATOL = 1e-5, 1e-6
LOG_ATOL, FINAL_RTOL, HEADS_ATOL, PROBE_TOL = 1e-4, 1e-5, 2e-5, 1e-3
MEASURE_KEYS = {"plain_tok_s", "medusa_tok_s", "speedup",
                "tokens_per_verify", "gamma", "max_len", "greedy"}
TREE_KEYS = {"plain_tok_s", "linear_tok_s", "tree_tok_s",
             "linear_tokens_per_verify", "tree_tokens_per_verify",
             "linear_speedup", "tree_speedup", "tree_step_premium",
             "tree_nodes", "gamma", "max_len", "reps", "spread_ms"}
TRAIN_KEYS = {"n_heads", "ckpt", "final_loss", "train_seconds", "probe"}


def _jax_loss(base, heads, batch_ids, cfg, pad_id):
    """JAX's head loss (eamg_tpu/tools/medusa.py, ``loss_fn`` of its
    ``step``) on ``eamg_tpu``'s forward."""
    x = batch_ids[:, :-1]
    h = jax.lax.stop_gradient(forward_hidden(base, x, cfg))
    total = count = jnp.zeros(())
    for k, blk in enumerate(heads["blocks"], start=1):
        hk = h + jax.nn.silu(h @ blk["w"].T + blk["b"])
        logits = (hk.astype(jnp.float32) @ base["head"]["w"].T
                  + base["head"]["b"])
        y = jnp.roll(batch_ids, -(1 + k), axis=1)[:, :-1]
        valid = (jnp.arange(x.shape[1])[None] < x.shape[1] - k) & (
            y != pad_id)
        nll = jax.nn.logsumexp(logits, axis=-1) - jnp.take_along_axis(
            logits, y[..., None], axis=-1)[..., 0]
        total = total + jnp.sum(nll * valid)
        count = count + jnp.sum(valid)
    return total / jnp.maximum(count, 1)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_medusa")
    vocab = demo_pipeline().generator.vocab
    cfg = GPTConfig(vocab_size=len(vocab), seq_len=SEQ, d_model=32,
                    n_head=4, n_layer=2, pos_rows=SEQ, causal=True)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(2),
                                                  cfg))
    ckpt = tmp / "ckpt"
    save_checkpoint(str(ckpt), params, vocab.tok2id, cfg)
    ref = {}
    logs = []
    res = train_medusa_heads(str(ckpt), str(tmp / "jax_heads.pkl"),
                             MedusaSpec(**SPEC), log_fn=logs.append)
    ref["train"] = res
    ref["logs"] = logs
    with open(tmp / "jax_heads.pkl", "rb") as f:
        ref["pickle"] = pickle.load(f)
    # the head loss and one AdamW step on random heads and a batch
    rng = np.random.default_rng(5)
    heads = {"blocks": [{"w": (0.05 * rng.standard_normal((32, 32))).astype(
        np.float32), "b": (0.01 * rng.standard_normal(32)).astype(
            np.float32)} for _ in range(3)]}
    rows = [rng.integers(3, len(vocab), int(n)).tolist()
            for n in rng.integers(10, SEQ, 4)]
    ids = pad_rows(rows, SEQ, 0)
    jp = jax.tree.map(jnp.asarray, params)
    jh = jax.tree.map(jnp.asarray, heads)
    loss, grads = jax.value_and_grad(
        lambda hd: _jax_loss(jp, hd, jnp.asarray(ids), cfg, 0))(jh)
    opt = optax.adamw(SPEC["lr"])
    updates, _ = opt.update(grads, opt.init(jh), jh)
    ref["loss"] = float(loss)
    ref["step"] = jax.tree.map(np.asarray, optax.apply_updates(jh, updates))
    inp = {"ckpt/dir": np.asarray(str(ckpt)),
           "spec": np.asarray(json.dumps(SPEC)), "loss/ids": ids,
           "ckpt/cfg": cfg_json(cfg),
           "ckpt/vocab": np.asarray(json.dumps(vocab.tok2id))}
    inp.update(flatten(heads, "loss/heads"))
    inp.update(flatten(params, "ckpt/p"))
    got = run_worker("train_medusa", inp, tmp)
    port_pkl = tmp / "port_heads.pkl"
    port_pkl.write_bytes(got["train/pickle"].tobytes())
    ref["port_loaded"] = load_medusa_heads(str(port_pkl))
    with open(port_pkl, "rb") as f:
        ref["port_raw"] = pickle.load(f)
    return got, ref


def test_head_loss_matches_jax(results):
    got, ref = results
    np.testing.assert_allclose(float(got["loss/value"]), ref["loss"],
                               rtol=LOSS_RTOL)


def test_one_adamw_step_matches_optax(results):
    got, ref = results
    for i, blk in enumerate(ref["step"]["blocks"]):
        np.testing.assert_allclose(got[f"loss/step/w/{i}"], blk["w"],
                                   atol=STEP_ATOL, rtol=0)
        np.testing.assert_allclose(got[f"loss/step/b/{i}"], blk["b"],
                                   atol=STEP_ATOL, rtol=0)


def test_training_losses_match_jax(results):
    got, ref = results

    def losses(lines):
        return [float(s.split("head_loss=")[1]) for s in lines
                if "head_loss=" in s]

    port_logs = json.loads(str(got["train/logs"]))
    assert len(losses(port_logs)) == SPEC["epochs"]
    np.testing.assert_allclose(losses(port_logs), losses(ref["logs"]),
                               atol=LOG_ATOL, rtol=0)
    np.testing.assert_allclose(float(got["train/final_loss"]),
                               ref["train"]["final_loss"], rtol=FINAL_RTOL)


def test_trained_heads_match_jax(results):
    got, ref = results
    for i, blk in enumerate(ref["train"]["blocks"]):
        np.testing.assert_allclose(got[f"train/w/{i}"], blk["w"],
                                   atol=HEADS_ATOL, rtol=0)
        np.testing.assert_allclose(got[f"train/b/{i}"], blk["b"],
                                   atol=HEADS_ATOL, rtol=0)


def test_probe_matches_jax(results):
    got, ref = results
    port, jx = json.loads(str(got["train/probe"])), ref["train"]["probe"]
    assert set(port) == set(jx)
    for k, v in jx.items():
        if isinstance(v, list):
            np.testing.assert_allclose(port[k], v, atol=PROBE_TOL)
        elif isinstance(v, bool):
            assert port[k] == v, k
        else:
            np.testing.assert_allclose(port[k], v, atol=PROBE_TOL, err_msg=k)


def test_port_pickle_loads_in_jax(results):
    _, ref = results
    raw, jraw = ref["port_raw"], ref["pickle"]
    assert set(raw) == set(jraw) == TRAIN_KEYS | {"blocks"}
    assert raw["n_heads"] == jraw["n_heads"] == SPEC["n_heads"]
    loaded = ref["port_loaded"]
    assert len(loaded["blocks"]) == SPEC["n_heads"]
    for blk, jblk in zip(loaded["blocks"], jraw["blocks"]):
        for k in ("w", "b"):
            assert blk[k].shape == jblk[k].shape
            assert blk[k].dtype == jnp.float32 == jblk[k].dtype
    assert loaded["probe"] == raw["probe"]


@pytest.mark.parametrize("name", ("train", "linear", "tree"))
def test_cli_json_keys(results, name):
    got, _ = results
    assert int(got[f"cli/{name}/code"]) == 0
    res = json.loads(str(got[f"cli/{name}/json"]))
    if name == "train":
        assert set(res) == {"train", "measure"}
        assert set(res["train"]) == TRAIN_KEYS
        assert set(res["measure"]) == MEASURE_KEYS
    elif name == "linear":
        assert set(res) == {"linear"} and set(res["linear"]) == MEASURE_KEYS
    else:
        assert set(res) == {"tree"} and set(res["tree"]) == TREE_KEYS


@pytest.mark.parametrize("where", ("dir", "default"))
def test_profile_endpoint(results, where):
    got, _ = results
    assert int(got[f"profile/{where}/status"]) == 200
    assert json.loads(str(got[f"profile/{where}/keys"])) == ["trace_dir",
                                                             "view"]
    assert bool(got[f"profile/{where}/trace"])
    assert int(got[f"profile/{where}/events"]) > 0
    assert bool(got[f"profile/{where}/at_dir"]) == (where == "dir")
