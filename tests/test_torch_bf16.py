"""The port's bf16 model against the model the JAX package serves, on the
CPU.

Every shipped demo checkpoint is bf16 with ``kernels="xla"``, so JAX
serves its FFN as ``_linear`` -> activation -> ``_linear``
(``eamg_tpu/models/gpt.py::_mlp``): ``x W1^T`` rounded to bf16, plus the
bias in bf16 (rounded again), the activation, and the same for the second
product. ``kernels="pallas"`` selects the fused kernel's order instead
(bias added to the f32 sum, one rounding). The port's ``_mlp`` reads
``cfg.kernels`` and follows the order it names. Inputs are made with numpy
from a seed; the torch side runs in one subprocess
(tests/torch_port_worker.py, task ``bf16``).

Checked, with the tolerance and its reason:
- ``_mlp`` at the flagship's width (D 512, FF 2048), bf16, random bf16
  weights, 64 rows: the port with ``kernels="xla"`` against JAX with
  ``kernels="xla"`` compiled, as it is served. The two sum the products in
  other orders, so a few outputs that lie near a rounding boundary round
  the other way: at most 1% of the outputs may differ, and none by more
  than one bf16 step of its row's largest output. The Pallas order
  differs from JAX's served one in ~60% of them.
- in f32 the two orders are one function: the port's ``_mlp`` under either
  setting against JAX's under either (``"pallas"`` runs the Pallas kernel
  in interpret mode) to 1e-5.
- the flagship ``demo_ckpt_a`` in bf16, teacher-forced: logits of a
  16-token prompt (``prefill``) and of 32 forced tokens (``decode_step``),
  the port on the CPU against JAX ``kernels="xla"`` on the CPU, compiled as
  it is served. The same bf16 model rounds a value that lies near a
  rounding boundary the other way now and then, depending only on the
  order of a sum, and one such step in the residual stream of this
  post-LN model moves the f32 logits (|logit| up to ~19 here) by up to
  about 1. JAX's own two executions of the model show it: compiled and op
  by op they differ by up to 0.64 (mean 0.057) on these inputs, and by up
  to 1.38 on others (the port, eager like the op-by-op run, gave its
  prefill logits bit for bit until the first such step there). So the
  port is held to JAX's own spread: max |delta logit| <= 1.5, mean
  |delta logit| <= 1.25x the mean between JAX's two executions, and at
  least 40 of the 48 greedy argmaxes equal (JAX's two executions agree on
  45 here, 43 on the other inputs; a near-tie of the two largest logits
  flips).
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.models.gpt import (GPTConfig, _mlp, decode_step,
                                 init_kv_cache, prefill)
from eamg_tpu.utils.checkpoint import load_checkpoint

from port_harness import cfg_json, flatten, run_worker

REPO = Path(__file__).resolve().parents[1]
DEMO_A = REPO / "eamg_tpu" / "serve" / "demo_ckpt_a"

D, FF, ROWS = 512, 2048, 64
ACTS = ("relu", "gelu")
KERNELS = ("xla", "pallas")
DIFFER_MAX = 0.01            # share of bf16 outputs that may differ
F32_TOL = 1e-5
PROMPT, FORCED = 16, 32
TF_TOL = 1.5
TF_MEAN_OF_SPREAD = 1.25
ARGMAX_AGREE_MIN = 40


def _cfg(act, dtype, kernels):
    return GPTConfig(vocab_size=97, seq_len=64, d_model=D, n_head=8,
                     n_layer=1, activation=act, dtype=dtype,
                     kernels=kernels)


def _eager(fn):
    return fn


def _served(fn):
    """fn compiled, as JAX serves it: XLA rounds where the compiled program
    rounds, which is not always where the same ops run one by one round
    (the bf16 exact gelu differs)."""
    return jax.jit(fn)


def _mlp_case(rng, act, inp, ref):
    x = rng.standard_normal((ROWS, D)).astype(np.float32)
    p = {"w1": rng.uniform(-1, 1, (FF, D)) / math.sqrt(D),
         "b1": rng.uniform(-1, 1, (FF,)) / math.sqrt(D),
         "w2": rng.uniform(-1, 1, (D, FF)) / math.sqrt(FF),
         "b2": rng.uniform(-1, 1, (D,)) / math.sqrt(FF)}
    p32 = {k: v.astype(np.float32) for k, v in p.items()}
    # bf16: x, weights and biases as a bf16 checkpoint holds them
    xb = jnp.asarray(x, jnp.bfloat16)
    pb = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p32.items()}
    inp.update(flatten({"x": np.asarray(xb), **{k: np.asarray(v)
                                               for k, v in pb.items()}},
                       f"mlp/{act}/bf16"))
    inp.update(flatten({"x": x, **p32}, f"mlp/{act}/f32"))
    cfg = _cfg(act, "bfloat16", "xla")
    ref[("bf16", act)] = np.asarray(_served(lambda p, x: _mlp(p, x, cfg))(
        pb, xb).astype(jnp.float32))
    for kernels in KERNELS:
        inp[f"mlp/{act}/cfg/{kernels}"] = cfg_json(
            _cfg(act, "bfloat16", kernels))
        cfg = _cfg(act, "float32", kernels)
        ref[("f32", act, kernels)] = np.asarray(_served(
            lambda p, x, cfg=cfg: _mlp(p, x, cfg))(
                {k: jnp.asarray(v) for k, v in p32.items()},
                jnp.asarray(x)))


def _flagship_case(rng, inp, ref):
    ck = load_checkpoint(str(DEMO_A))
    cfg = ck["cfg"]
    assert (cfg.dtype, cfg.kernels) == ("bfloat16", "xla")
    ids = rng.integers(0, cfg.vocab_size, (1, PROMPT)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (FORCED,)).astype(np.int32)
    inp["tf/ids"], inp["tf/forced"] = ids, forced
    params = jax.tree.map(jnp.asarray, ck["params"])
    for how, run in (("tf", _served), ("tf_eager", _eager)):
        cache = init_kv_cache(cfg, 1, PROMPT + FORCED)
        logits, cache = run(lambda p, i, c: prefill(p, i, cfg, c))(
            params, jnp.asarray(ids), cache)
        out = [np.asarray(logits[0], np.float32)]
        last = ids[:, -1:]
        step = run(lambda p, i, c: decode_step(p, i, c, cfg))
        for tok in forced:
            lg, cache = step(params, jnp.asarray(last), cache)
            out.append(np.asarray(lg, np.float32))
            last = np.full((1, 1), tok, np.int32)
        ref[how] = np.concatenate(out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(606)
    inp, ref = {"acts": np.asarray(ACTS)}, {}
    for act in ACTS:
        _mlp_case(rng, act, inp, ref)
    _flagship_case(rng, inp, ref)
    got = run_worker("bf16", inp, tmp_path_factory.mktemp("bf16"))
    return got, ref


def _bf16_step(a: np.ndarray) -> np.ndarray:
    """One bf16 step (8 significant bits) at |a| > 0."""
    return 2.0 ** (np.floor(np.log2(np.abs(a))) - 7)


@pytest.mark.parametrize("act", ACTS)
def test_bf16_mlp_rounds_as_jax_serves(results, act):
    """The port's bf16 _mlp under kernels="xla" against JAX's: at most 1%
    of the outputs differ, none by more than one bf16 step of the row's
    largest output, the scale at which the row's sums were rounded (an
    output near 0 is the difference of two such sums, so one step of the
    output itself would be far finer than any rounding of its terms)."""
    got, ref = results
    a, b = got[f"mlp/{act}/bf16/xla"], ref[("bf16", act)]
    assert a.shape == b.shape == (ROWS, D)
    assert (a != b).mean() <= DIFFER_MAX, (a != b).sum()
    step = _bf16_step(np.abs(b).max(axis=1, keepdims=True))
    assert (np.abs(a - b) <= step).all(), (np.abs(a - b) / step).max()


@pytest.mark.parametrize("act", ACTS)
def test_bf16_mlp_pallas_order_is_another_function(results, act):
    """kernels="pallas" keeps the fused kernel's order (one rounding), which
    is not the function JAX serves: many outputs differ from it."""
    got, ref = results
    assert (got[f"mlp/{act}/bf16/pallas"] != ref[("bf16", act)]).mean() \
        > 0.2


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("kernels", KERNELS)
@pytest.mark.parametrize("against", KERNELS)
def test_f32_mlp_orders_are_one_function(results, act, kernels, against):
    got, ref = results
    np.testing.assert_allclose(got[f"mlp/{act}/f32/{kernels}"],
                               ref[("f32", act, against)], rtol=F32_TOL,
                               atol=F32_TOL)


def test_flagship_bf16_teacher_forced_logits_match_jax(results):
    got, ref = results
    a, b = got["tf"], ref["tf"]
    assert a.shape == b.shape == (PROMPT + FORCED, b.shape[1])
    assert np.isfinite(a).all()
    spread = np.abs(ref["tf_eager"] - b).mean()
    assert np.abs(a - b).max() <= TF_TOL, np.abs(a - b).max()
    assert np.abs(a - b).mean() <= TF_MEAN_OF_SPREAD * spread, (
        np.abs(a - b).mean(), spread)


def test_flagship_bf16_greedy_argmaxes_agree(results):
    got, ref = results
    agree = int((got["tf"].argmax(-1) == ref["tf"].argmax(-1)).sum())
    assert agree >= ARGMAX_AGREE_MIN, agree
