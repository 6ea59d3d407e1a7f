"""The port's expert parallelism against the JAX package's, on the CPU.

JAX runs ``eamg_tpu/parallel/moe.py::moe_mlp_ep`` here on an ``expert``
mesh of 2 and of 4 virtual devices; the port runs ``moe_mlp_ep`` in one
subprocess (tests/torch_port_worker.py, task ``ep``) that spawns gloo
worlds of 4 and 2 ranks, each holding E/n experts and its N/n tokens.
The MoE is tests/test_moe.py's: d16, FF 32, 8 experts, top-2, x [2, 32,
16].

Checked, with the tolerance and its reason, for each capacity of CAPS
(drop-free: top_k x the rank's tokens; overflow: 2 slots an expert a
rank, so tokens drop per rank; the default from the capacity factor):
- the output, joined over the ranks, against JAX's: 1e-5 (f32 sums of the
  one-hot products in another order);
- the gradient of sum(y * w): of x, of each rank's experts (joined) and
  of the router (summed over the ranks) against ``jax.grad`` of JAX's:
  1e-5 x max |g| of the leaf;
- drop-free, the output against JAX's ``moe_mlp_dense`` (1e-5): the
  all_to_alls move tokens and change no value;
- with the overflow capacity, some rows differ from drop-free (tokens were
  dropped) and still match JAX's per-rank drops.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from eamg_tpu.parallel.moe import (MoEConfig, init_moe_params,
                                   moe_mlp_dense, moe_mlp_ep,
                                   shard_moe_params)

from port_harness import flatten, start_worker

MCFG = MoEConfig(d_model=16, d_ff=32, n_experts=8, top_k=2)
WORLDS = (2, 4)
B, T = 2, 32
TOL = 1e-5


def _caps(n):
    return {"nodrop": MCFG.top_k * (B * T // n), "overflow": 2,
            "default": 0}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(31)
    tmp = tmp_path_factory.mktemp("ep")
    params = jax.tree.map(np.asarray, init_moe_params(
        jax.random.PRNGKey(2), MCFG))
    x = rng.standard_normal((B, T, MCFG.d_model)).astype(np.float32)
    w = rng.standard_normal((B, T, MCFG.d_model)).astype(np.float32)
    inp = {**flatten(params, "ep/p"), "ep/x": x, "ep/w": w,
           "ep/mcfg": np.asarray(json.dumps(MCFG.__dict__)),
           "ep/caps": np.asarray(json.dumps(
               {str(n): _caps(n) for n in WORLDS}))}
    worker = start_worker("ep", inp, tmp, timeout=600)
    ref = {}
    jp = jax.tree.map(jnp.asarray, params)
    for n in WORLDS:
        mesh = Mesh(np.asarray(jax.devices()[:n]), ("expert",))
        sharded = shard_moe_params(jp, mesh)
        for name, cap in _caps(n).items():
            def loss(p, xx, cap=cap, mesh=mesh):
                y = moe_mlp_ep(p, xx, MCFG, mesh, capacity=cap or None)
                return jnp.sum(y * w), y

            (_, y), (gp, gx) = jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True)(sharded, jnp.asarray(x))
            ref[(n, name)] = {"y": np.asarray(y).reshape(B * T, -1),
                              "dx": np.asarray(gx).reshape(B * T, -1),
                              **{k: np.asarray(v) for k, v in gp.items()}}
        ref[(n, "dense")] = np.asarray(moe_mlp_dense(
            jp, jnp.asarray(x), MCFG, capacity=MCFG.top_k * B * T)) \
            .reshape(B * T, -1)
    return worker(), ref


def _joined(got, n, key):
    return np.concatenate([got[f"w{n}/r{r}/{key}"] for r in range(n)])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("cap", ["nodrop", "overflow", "default"])
def test_ep_output_matches_jax(results, n, cap):
    got, ref = results
    np.testing.assert_allclose(_joined(got, n, f"{cap}/y"),
                               ref[(n, cap)]["y"], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("cap", ["nodrop", "overflow", "default"])
def test_ep_gradients_match_jax(results, n, cap):
    got, ref = results
    r = ref[(n, cap)]
    pairs = {"dx": _joined(got, n, f"{cap}/dx"),
             "router": got[f"w{n}/r0/{cap}/router"],
             **{k: _joined(got, n, f"{cap}/{k}")
                for k in ("w1", "b1", "w2", "b2")}}
    for k, g in pairs.items():
        want = r[k]
        assert g.shape == want.shape, k
        assert np.abs(g - want).max() <= TOL * np.abs(want).max(), k
    assert np.abs(pairs["router"]).sum() > 0


@pytest.mark.parametrize("n", WORLDS)
def test_drop_free_ep_equals_dense(results, n):
    got, ref = results
    np.testing.assert_allclose(_joined(got, n, "nodrop/y"),
                               ref[(n, "dense")], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_overflow_drops_tokens_per_rank(results, n):
    got, _ = results
    a, b = _joined(got, n, "overflow/y"), _joined(got, n, "nodrop/y")
    assert np.abs(a - b).max(axis=1).max() > 1e-3
