"""The port's model variants against the JAX package on the CPU: int8
weights (eamg_tpu_torch/models/quant.py and the int8 leaves of
models/gpt.py), the MoE FFN (parallel/moe.py), MoE layers in the GPT and
in training (train/trainer.py::loss_fn_moe, cli train --experts).

The torch side runs in one subprocess (tests/torch_port_variants.py, task
"variants"). Tolerances:
- quantize_weight: q and s bit-equal in f32 and bf16 (a zero row, ties at
  .5 among them), the quantize_params trees bit-equal, quantization_error
  within 1e-6; an int8 tree through checkpoints both ways (the port's read
  by JAX's load_checkpoint, JAX's by the port's), int8 leaves as int8, and
  JAX's MoE checkpoint read by the port (the port's is read by JAX in the
  cli train check);
- int8 forward: f32 logits within 1e-5 of jax.jit(forward), bf16 within
  BF16_LOGIT_TOL (the bf16 products round in other orders); f32
  decode_block (int8 + GQA-2) within 1e-5; greedy generate_kv tokens
  equal for int8 and int8 + GQA-2;
- the MoE functions (_gates on a random, a tie, the adversarial and a
  top-1 router; the dispatch tensors; moe_mlp_dense with capacity drops;
  moe_mlp_pointwise; load_balance_loss): ids and dispatch equal, values
  within 1e-5;
- MoE GPT: init_params bit-equal for moe_every 1 and 2 (the N(0, 1)
  tok_emb within ERF_INV_ULPS ulps, as tests/test_torch_train.py holds
  it), forward within 1e-5, greedy generate_kv equal to JAX's and to the
  port's generate_full under tests/test_moe.py's adversarial router; an
  engine row equals its solo decode (generate_kv_ragged) and JAX's;
- MoE training: loss_fn_moe within 1e-5 relative and its gradients within
  1e-5 x max|g| of jax.grad's; three Trainer steps within 1e-5 (losses
  relative, params absolute); the chunked head and packed rows refused
  with the aux loss, as JAX asserts; cli train --experts on the host gives
  JAX's summary and checkpoint config.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode import generate_kv
from eamg_tpu.decode.ragged import generate_kv_ragged
from eamg_tpu.models import quant
from eamg_tpu.models.gpt import (GPTConfig, decode_block, forward,
                                 init_kv_cache, init_params, prefill)
from eamg_tpu.parallel import moe
from eamg_tpu.train.run import run_training
from eamg_tpu.train.trainer import (TrainConfig, Trainer, loss_fn_moe,
                                    make_train_step)
from eamg_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

from port_harness import cfg_json, flatten, perturbed_params, run_worker

F32_TOL = 1e-5
# bf16 int8 logits: max |port - JAX| 1.09e-2 on this model (the bf16
# products and the rest of the bf16 model round in other orders)
BF16_LOGIT_TOL = 3e-2
ERF_INV_ULPS = 3
SMALL = dict(vocab_size=40, seq_len=32, d_model=32, n_head=4, n_layer=2,
             causal=True)
INT8_CASES = {"int8": dict(SMALL), "int8_gqa2": dict(SMALL, n_kv_heads=2),
              "int8_pre_gelu": dict(SMALL, ln_placement="pre",
                                    activation="gelu"),
              "int8_bf16": dict(SMALL, dtype="bfloat16")}
MOE_CFG = dict(d_model=16, d_ff=32, n_experts=8, top_k=2)
MOE_CASES = ("random", "tie", "adversarial", "top1", "top1_tie")
MOE_INIT = {"every1": dict(SMALL, vocab_size=64, n_experts=4),
            "every2": dict(SMALL, vocab_size=64, n_experts=4, moe_every=2,
                           n_layer=3)}
# tests/test_moe.py:168: pre-LN gelu, capacity factor 0.25, routers
# skewed hard towards expert 0
MOE_GPT = dict(vocab_size=64, seq_len=32, d_model=32, n_head=4, n_layer=2,
               causal=True, ln_placement="pre", activation="gelu",
               n_experts=4, moe_capacity_factor=0.25)
MOE_ENGINE = dict(vocab_size=64, seq_len=48, d_model=32, n_head=4,
                  n_layer=2, pos_rows=48, causal=True, n_experts=4)
ENGINE_REQUESTS = [[[1, 2, 3], 9], [[4, 5], 3], [[7, 8, 9, 10], 12]]
MOE_TRAIN = dict(vocab_size=48, seq_len=24, d_model=32, n_head=4,
                 n_layer=2, causal=True, n_experts=4, moe_every=2)
TRAIN_STEPS, MICRO, T = 3, 4, 23
CLI_TRAIN = ["train", "--preset", "mini", "--corrected", "--synthetic", "16",
             "--epochs", "1", "--d-model", "32", "--n-layer", "2",
             "--seq-len", "32", "--experts", "4", "--moe-every", "2",
             "--log-every", "1", "--save-every", "0"]


def _quant_weight(rng) -> np.ndarray:
    w = rng.standard_normal((6, 40)).astype(np.float32)
    w[0] = 0.0                                        # s at its floor
    w[1] = 0.0
    w[1, :8] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5, 63.5]  # ties
    w[2] *= 1e-3
    return w


def _moe_case(name, rng):
    cfg = moe.MoEConfig(**dict(MOE_CFG, top_k=1 if name.startswith("top1")
                               else 2))
    params = jax.tree.map(np.asarray,
                          moe.init_moe_params(jax.random.PRNGKey(11), cfg))
    router = params["router"].copy()
    capacity = None
    if name in ("tie", "top1_tie"):
        # two equal rows ahead of the rest: an exact tie on every token
        router[5] = router[2] = 20.0 * np.abs(router[2])
    if name == "adversarial":
        router[:] = 0.0
        router[0] = 3.0
        capacity = 2
    params["router"] = router
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    if name in ("tie", "top1_tie"):
        x = np.abs(x)
    cap = capacity or 3
    return cfg, params, x, cap


def _skewed_moe_params(cfg):
    params = init_params(jax.random.PRNGKey(12), cfg)
    for li in range(cfg.n_layer):
        r = params["layers"][li]["mlp"]["router"]
        skew = jax.random.normal(jax.random.PRNGKey(100 + li), r.shape)
        params["layers"][li]["mlp"]["router"] = (skew * 0.5).at[0].multiply(
            8.0)
    return jax.tree.map(np.asarray, params)


def _train_batches(rng):
    x = rng.integers(1, MOE_TRAIN["vocab_size"], (TRAIN_STEPS, 1, MICRO, T))
    y = rng.integers(1, MOE_TRAIN["vocab_size"], (TRAIN_STEPS, 1, MICRO, T))
    y[:, :, 0, -5:] = 0                                # PAD targets
    return x.astype(np.int32), y.astype(np.int32)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("variants")
    rng = np.random.default_rng(0)
    inp = {}
    ref = {}
    # quant
    w = _quant_weight(rng)
    ref["quant/w"] = {"f32": w, "bf16": np.asarray(
        jnp.asarray(w, jnp.bfloat16))}
    qcfg = GPTConfig(**SMALL)
    qparams = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(3),
                                                   qcfg))
    ref["quant/p"] = {"f32": qparams, "bf16": jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), qparams)}
    for dt in ("f32", "bf16"):
        inp[f"quant/w/{dt}"] = ref["quant/w"][dt].view(np.uint16) \
            if dt == "bf16" else ref["quant/w"][dt]
        inp.update(flatten(ref["quant/p"][dt], f"quant/p/{dt}"))
    save_checkpoint(str(tmp / "jax_int8"), jax.tree.map(
        np.asarray, quant.quantize_params(qparams)), {"a": 0}, qcfg)
    inp["quant/cfg"] = cfg_json(qcfg)
    moe_ck = GPTConfig(**MOE_INIT["every2"])
    ref["quant/moe"] = (moe_ck, jax.tree.map(np.asarray, init_params(
        jax.random.PRNGKey(6), moe_ck)))
    save_checkpoint(str(tmp / "jax_moe"), ref["quant/moe"][1], {"a": 0},
                    moe_ck)
    inp["quant/ckpt"] = np.asarray(json.dumps(
        {"port": str(tmp / "port_int8"), "jax": str(tmp / "jax_int8"),
         "jax_moe": str(tmp / "jax_moe")}))
    # int8 models
    ids = rng.integers(1, SMALL["vocab_size"], (2, 12)).astype(np.int32)
    prompt = np.zeros((2, 4), np.int32)
    prompt[:, :3] = [[1, 2, 3], [4, 5, 6]]
    inp["int8/ids"], inp["int8/prompt"] = ids, prompt
    ref["int8/ids"], ref["int8/prompt"] = ids, prompt
    inp["int8/cases"] = np.asarray(json.dumps(list(INT8_CASES)))
    for name, kw in INT8_CASES.items():
        cfg = GPTConfig(**kw)
        params = jax.tree.map(np.asarray, quant.quantize_params(
            perturbed_params(cfg, rng, key=4)))
        ref[f"int8/{name}"] = (cfg, params)
        inp[f"int8/{name}/cfg"] = cfg_json(cfg)
        inp.update(flatten(params, f"int8/{name}/p"))
    # MoE functions
    inp["moe/cases"] = np.asarray(json.dumps(MOE_CASES))
    for name in MOE_CASES:
        cfg, params, x, cap = _moe_case(name, rng)
        ref[f"moe/{name}"] = (cfg, params, x, cap)
        inp[f"moe/{name}/spec"] = np.asarray(json.dumps(
            {"cfg": dataclasses.asdict(cfg), "capacity": cap}))
        inp.update(flatten(params, f"moe/{name}/p"))
        inp[f"moe/{name}/x"] = x
    # MoE GPTs
    inp["moe_init/cases"] = np.asarray(json.dumps(list(MOE_INIT)))
    for name, kw in MOE_INIT.items():
        inp[f"moe_init/{name}/cfg"] = cfg_json(GPTConfig(**kw))
    gcfg = GPTConfig(**MOE_GPT)
    gparams = _skewed_moe_params(gcfg)
    ref["moe_gpt"] = (gcfg, gparams)
    inp["moe_gpt/cfg"] = cfg_json(gcfg)
    inp.update(flatten(gparams, "moe_gpt/p"))
    inp["moe_gpt/prompt"] = prompt
    inp["moe_gpt/ids"] = ref["moe_gpt/ids"] = rng.integers(
        1, 64, (2, 10)).astype(np.int32)
    ecfg = GPTConfig(**MOE_ENGINE)
    eparams = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(5),
                                                   ecfg))
    ref["moe_engine"] = (ecfg, eparams)
    inp["moe_engine/cfg"] = cfg_json(ecfg)
    inp.update(flatten(eparams, "moe_engine/p"))
    inp["moe_engine/requests"] = np.asarray(json.dumps(ENGINE_REQUESTS))
    # MoE training
    tcfg = GPTConfig(**MOE_TRAIN)
    tparams = perturbed_params(tcfg, rng, key=9)
    x, y = _train_batches(rng)
    ref["moe_train"] = (tcfg, tparams, x, y)
    inp["moe_train/cfg"] = cfg_json(tcfg)
    inp.update(flatten(tparams, "moe_train/p"))
    inp["moe_train/x"], inp["moe_train/y"] = x, y
    inp["moe_train/tcfg"] = np.asarray(json.dumps(dict(micro_batch=MICRO)))
    inp["moe_train/cli"] = np.asarray(json.dumps(
        CLI_TRAIN + ["--device", "cpu", "--out", str(tmp / "port_cli")]))
    got = run_worker("variants", inp, tmp, timeout=900)
    return got, ref, tmp


# ------------------------------------------------------------------ quant

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_weight_bit_equal(results, dt):
    got, ref, _ = results
    want = quant.quantize_weight(jnp.asarray(ref["quant/w"][dt]))
    np.testing.assert_array_equal(got[f"quant/q/{dt}"], np.asarray(want["q"]))
    assert got[f"quant/q/{dt}"].dtype == np.int8
    np.testing.assert_array_equal(got[f"quant/s/{dt}"], np.asarray(want["s"]))
    assert got[f"quant/s/{dt}"].dtype == np.float32
    np.testing.assert_array_equal(got[f"quant/deq/{dt}"], np.asarray(
        quant.dequantize_weight(want)))
    # the zero row at the floor, the ties rounded half to even
    assert got[f"quant/s/{dt}"][0] > 0
    assert list(got[f"quant/q/{dt}"][1, :8]) == [127, 2, -4, 0, 0, 2, -126,
                                                 64]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_quantize_params_tree_equal(results, dt):
    got, ref, _ = results
    want_tree = quant.quantize_params(jax.tree.map(jnp.asarray,
                                                   ref["quant/p"][dt]))
    want = flatten(jax.tree.map(np.asarray, want_tree), f"quant/qp/{dt}")
    assert set(want) == {k for k in got if k.startswith(f"quant/qp/{dt}/")}
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    err = quant.quantization_error(jax.tree.map(jnp.asarray,
                                                ref["quant/p"][dt]),
                                   want_tree)
    assert abs(float(got[f"quant/err/{dt}"]) - err) <= 1e-6


def test_int8_and_moe_checkpoints_interoperate_with_jax(results):
    got, ref, tmp = results
    want = flatten(jax.tree.map(np.asarray, quant.quantize_params(
        ref["quant/p"]["f32"])), "p")
    # the port's checkpoint of its int8 tree, read by JAX
    port = flatten(load_checkpoint(str(tmp / "port_int8"))["params"], "p")
    # JAX's checkpoint of its int8 tree, read by the port
    loaded = {"p" + k[len("quant/loaded"):]: v for k, v in got.items()
              if k.startswith("quant/loaded/")}
    assert set(port) == set(loaded) == set(want)
    assert sum(w.dtype == np.int8 for w in want.values()) == 9
    for k, w in want.items():
        for side in (port, loaded):
            assert side[k].dtype == w.dtype, k
            np.testing.assert_array_equal(side[k], w, err_msg=k)
    # and an MoE tree (3-D experts, a router) with its config, as JAX wrote
    cfg, params = ref["quant/moe"]
    want = flatten(params, "quant/moe_loaded")
    assert set(want) == {k for k in got
                         if k.startswith("quant/moe_loaded/")}
    assert got["quant/moe_loaded/layers/1/mlp/w1"].ndim == 3
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert json.loads(str(got["quant/moe_cfg"])) == dataclasses.asdict(cfg)


# ------------------------------------------------------------------- int8

@pytest.mark.parametrize("name", list(INT8_CASES))
def test_int8_forward_matches_jax(results, name):
    got, ref, _ = results
    cfg, params = ref[f"int8/{name}"]
    ids = jnp.asarray(ref["int8/ids"])
    want = np.asarray(jax.jit(forward, static_argnames="cfg")(
        jax.tree.map(jnp.asarray, params), ids, cfg), np.float32)
    tol = BF16_LOGIT_TOL if cfg.dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got[f"int8/{name}/logits"], want, rtol=0,
                               atol=tol)


@pytest.mark.parametrize("name", ["int8_gqa2"])
def test_int8_decode_block_matches_jax(results, name):
    got, ref, _ = results
    cfg, params = ref[f"int8/{name}"]
    p = jax.tree.map(jnp.asarray, params)
    ids = jnp.asarray(ref["int8/ids"])
    cache = init_kv_cache(cfg, 2, cfg.seq_len)
    _, cache = prefill(p, ids[:, :6], cfg, cache)
    want, _ = decode_block(p, ids[:, 6:9], cache, cfg)
    np.testing.assert_allclose(got[f"int8/{name}/block"], np.asarray(want),
                               rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("name", ["int8", "int8_gqa2"])
def test_int8_greedy_stream_equals_jax(results, name):
    got, ref, _ = results
    cfg, params = ref[f"int8/{name}"]
    buf, pos = generate_kv(jax.tree.map(jnp.asarray, params),
                           jnp.asarray(ref["int8/prompt"]), 3,
                           jax.random.PRNGKey(0), cfg, 20, greedy=True,
                           eos_id=-1, pad_id=0, refeed_last_prompt=False)
    np.testing.assert_array_equal(got[f"int8/{name}/greedy"],
                                  np.asarray(buf)[:, :int(pos)])


# ------------------------------------------------------------ MoE functions

@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_gates_and_dispatch_equal_jax(results, name):
    got, ref, _ = results
    cfg, params, x, cap = ref[f"moe/{name}"]
    p = jax.tree.map(jnp.asarray, params)
    gates, idx = moe._gates(p, jnp.asarray(x.reshape(-1, cfg.d_model)), cfg)
    np.testing.assert_array_equal(got[f"moe/{name}/idx"], np.asarray(idx))
    np.testing.assert_allclose(got[f"moe/{name}/gates"], np.asarray(gates),
                               rtol=0, atol=F32_TOL)
    disp = jax.vmap(lambda e: moe._dispatch_tensors(e, cfg, cap))(
        idx.reshape(cfg.top_k, *x.shape[:2]).swapaxes(0, 1))
    np.testing.assert_array_equal(got[f"moe/{name}/dispatch"],
                                  np.asarray(disp))
    if name in ("tie", "top1_tie"):
        # the lower index wins the tie, as lax.top_k orders it
        assert (np.asarray(idx)[0] == 2).all()
        if cfg.top_k == 2:
            assert (np.asarray(idx)[1] == 5).all()


@pytest.mark.parametrize("name", MOE_CASES)
def test_moe_mlp_paths_equal_jax(results, name):
    got, ref, _ = results
    cfg, params, x, cap = ref[f"moe/{name}"]
    p, xj = jax.tree.map(jnp.asarray, params), jnp.asarray(x)
    for key, want in (("dense", moe.moe_mlp_dense(p, xj, cfg, cap)),
                      ("dense_default", moe.moe_mlp_dense(p, xj, cfg)),
                      ("pointwise", moe.moe_mlp_pointwise(p, xj, cfg,
                                                          chunk=5))):
        np.testing.assert_allclose(got[f"moe/{name}/{key}"],
                                   np.asarray(want), rtol=0, atol=F32_TOL,
                                   err_msg=key)
    want = moe.load_balance_loss(p, xj.reshape(-1, cfg.d_model), cfg)
    assert abs(float(got[f"moe/{name}/aux"]) - float(want)) <= F32_TOL
    if name == "adversarial":
        # capacity 2 drops tokens: the capacity path differs from the
        # pointwise one, and the same tokens come out as zeros
        dense = got[f"moe/{name}/dense"]
        assert not np.allclose(dense, got[f"moe/{name}/pointwise"])
        dropped = np.all(dense == 0, axis=-1)
        assert dropped.sum() > 0
        np.testing.assert_array_equal(
            dropped, np.all(np.asarray(moe.moe_mlp_dense(p, xj, cfg, cap))
                            == 0, axis=-1))


# ----------------------------------------------------------------- MoE GPT

@pytest.mark.parametrize("name", list(MOE_INIT))
def test_moe_init_params_equal_jax(results, name):
    got, _, _ = results
    cfg = GPTConfig(**MOE_INIT[name])
    want = flatten(jax.tree.map(np.asarray,
                                init_params(jax.random.PRNGKey(5), cfg)),
                   f"moe_init/{name}/p")
    assert set(want) == {k for k in got
                         if k.startswith(f"moe_init/{name}/p/")}
    routers = [k for k in want if k.endswith("/mlp/router")]
    assert len(routers) == (2 if name == "every1" else 1)
    for k, w in want.items():
        if k.endswith("/tok_emb"):
            ulps = np.abs(got[k].view(np.int32).astype(np.int64)
                          - w.view(np.int32).astype(np.int64))
            assert ulps.max() <= ERF_INV_ULPS and (ulps > 0).mean() < 0.02
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_moe_forward_and_greedy_decode_equal_jax(results):
    got, ref, _ = results
    cfg, params = ref["moe_gpt"]
    p = jax.tree.map(jnp.asarray, params)
    want = forward(p, jnp.asarray(ref["moe_gpt/ids"]), cfg)
    np.testing.assert_allclose(got["moe_gpt/logits"], np.asarray(want),
                               rtol=0, atol=F32_TOL)
    buf, _ = generate_kv(p, jnp.asarray(ref["int8/prompt"]), 3,
                         jax.random.PRNGKey(0), cfg, 16, greedy=True,
                         eos_id=-1, pad_id=0, refeed_last_prompt=False)
    np.testing.assert_array_equal(got["moe_gpt/greedy_kv"], np.asarray(buf))
    # the pointwise path: the cached decode equals the full forward's
    np.testing.assert_array_equal(got["moe_gpt/greedy_full"],
                                  got["moe_gpt/greedy_kv"])


@pytest.mark.parametrize("i", range(len(ENGINE_REQUESTS)))
def test_moe_engine_row_equals_solo_and_jax(results, i):
    got, ref, _ = results
    cfg, params = ref["moe_engine"]
    ids, seed = ENGINE_REQUESTS[i]
    prompt = np.zeros((1, 16), np.int32)
    prompt[0, :len(ids)] = ids
    buf, pos = generate_kv_ragged(
        jax.tree.map(jnp.asarray, params), jnp.asarray(prompt),
        jnp.asarray([len(ids)], np.int32), jax.random.PRNGKey(seed)[None],
        cfg, 24, temperature=1.0, top_k=50, eos_id=-1, pad_id=0)
    want = np.asarray(buf)[0, :int(np.asarray(pos)[0])]
    np.testing.assert_array_equal(got[f"moe_engine/solo/{i}"], want)
    np.testing.assert_array_equal(got[f"moe_engine/row/{i}"], want)
    assert int(got["moe_engine/admitted"]) >= 2


# ------------------------------------------------------------ MoE training

def test_moe_loss_and_grads_equal_jax(results):
    got, ref, _ = results
    cfg, params, x, y = ref["moe_train"]

    def f(p):
        return loss_fn_moe(p, jnp.asarray(x[0, 0]), jnp.asarray(y[0, 0]),
                           cfg, 0, 0.01)

    (loss, count), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    assert int(got["moe_train/count"]) == int(count)
    assert abs(float(got["moe_train/loss"]) - float(loss)) <= \
        F32_TOL * abs(float(loss))
    want = flatten(jax.tree.map(np.asarray, grads), "moe_train/grad")
    assert set(want) == {k for k in got if k.startswith("moe_train/grad/")}
    scale = max(np.abs(w).max() for w in want.values())
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= F32_TOL * scale, k


def test_moe_trainer_steps_equal_jax(results):
    got, ref, _ = results
    cfg, params, x, y = ref["moe_train"]
    t = Trainer(cfg, TrainConfig(micro_batch=MICRO),
                jax.tree.map(jnp.asarray, params))
    losses = [t.train_step(x[i], y[i])["loss"] for i in range(TRAIN_STEPS)]
    np.testing.assert_allclose(got["moe_train/steps"], losses, rtol=F32_TOL,
                               atol=0)
    want = flatten(jax.tree.map(np.asarray, t.params), "moe_train/params")
    lr_sum = TRAIN_STEPS * TrainConfig().lr
    for k, w in want.items():
        if not k.endswith("/attn/in_b"):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=F32_TOL,
                                       err_msg=k)
            continue
        # the K rows of in_b get a gradient of rounding residue (zero in
        # exact arithmetic), which Adam moves by up to the rate; the rest
        # within 1e-5 (tests/test_torch_train.py holds the dense trainer so)
        ks = slice(cfg.d_model, cfg.d_model + cfg.kv_dim)
        rest = np.ones(w.shape, bool)
        rest[ks] = False
        np.testing.assert_allclose(got[k][rest], w[rest], rtol=0,
                                   atol=F32_TOL, err_msg=k)
        assert np.abs(got[k][ks] - w[ks]).max() <= 2 * lr_sum, k


@pytest.mark.parametrize("flag", ["loss_chunk", "pack"])
def test_moe_aux_refusals_as_jax(results, flag):
    got, ref, _ = results
    cfg = ref["moe_train"][0]
    with pytest.raises(AssertionError):
        make_train_step(cfg, TrainConfig(**{flag: 73 if flag == "loss_chunk"
                                            else True}))
    assert str(got[f"moe_train/refuse/{flag}"]).startswith("ValueError")


def test_cli_train_experts_equals_jax(results):
    got, _, tmp = results
    assert int(got["moe_train/cli_code"]) == 0
    summary = json.loads(str(got["moe_train/cli_stdout"]).splitlines()[-1])
    geometry = {"d_model": 32, "n_layer": 2, "seq_len": 32, "n_experts": 4,
                "moe_every": 2}
    want = run_training("mini", synthetic_rows=16, epochs=1, corrected=True,
                        geometry=geometry, save_every_steps=0,
                        out_dir=str(tmp / "jax_cli"), log_fn=lambda *_: None)
    assert summary["steps"] == want["steps"]
    assert summary["vocab_size"] == want["vocab_size"]
    np.testing.assert_allclose(summary["final_loss"], want["final_loss"],
                               rtol=1e-4)
    port = load_checkpoint(str(tmp / "port_cli" / "final"))
    jax_ck = load_checkpoint(str(tmp / "jax_cli" / "final"))
    assert port["cfg"] == jax_ck["cfg"]
    assert port["cfg"].n_experts == 4 and port["cfg"].moe_every == 2
    assert "router" in port["params"]["layers"][1]["mlp"]
    assert "router" not in port["params"]["layers"][0]["mlp"]
