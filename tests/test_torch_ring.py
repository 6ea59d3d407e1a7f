"""The port's ring attention and sequence-parallel forward against the JAX
package's, on the CPU.

JAX runs ``eamg_tpu/parallel/ring_attention.py`` here on a ``seq`` mesh of
2 and of 4 virtual devices; the port runs in one subprocess
(tests/torch_port_worker.py, task ``ring``) that spawns gloo worlds of 4
and 2 ranks, each rank returning its block of time; the test joins the
blocks in rank order.

Checked, with the tolerance and its reason:
- ``ring_attention`` on [2, 2, 64, 8], causal and bidirectional, at n 2
  and 4, against JAX's: f32 within atol 2e-6, rtol 1e-5 (one online
  softmax in one order: f32 sums of 16- or 32-key blocks); bf16 within
  atol 8e-3 (a bf16 output rounds at 2^-8 of its size, and p is rounded
  to bf16 before its product, as in JAX);
- ``forward_seq_parallel`` (d32, 4 heads, GQA-2, 2 layers, T 64, V 48)
  against JAX's at n 2 and 4: 2e-5 (JAX's own ring-versus-dense test
  holds 2e-4);
- the gradient of the masked CE of the whole sequence through it (the
  ranks' gradients summed over the ring) against ``jax.grad`` of JAX's:
  the loss within 1e-5 relative, every leaf within 1e-5 x max |g|, and
  every rank reports the same loss.
"""

from __future__ import annotations

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from eamg_tpu.models.gpt import GPTConfig
from eamg_tpu.parallel.ring_attention import (forward_seq_parallel,
                                              ring_attention)
from eamg_tpu.train.trainer import masked_ce_sums

from port_harness import cfg_json, flatten, perturbed_params, start_worker

CFG = GPTConfig(vocab_size=48, seq_len=65, d_model=32, n_head=4,
                n_layer=2, n_kv_heads=2, causal=True)
WORLDS = (2, 4)
F32_ATOL, F32_RTOL, BF16_ATOL = 2e-6, 1e-5, 8e-3
LOGIT_TOL, GRAD_TOL, LOSS_RTOL = 2e-5, 1e-5, 1e-5


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("seq",))


def _joined(got, world, key, axis):
    return np.concatenate([got[f"w{world}/r{r}/{key}"]
                           for r in range(world)], axis=axis)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(77)
    tmp = tmp_path_factory.mktemp("ring")
    qkv = {n: rng.standard_normal((2, 2, 64, 8)).astype(np.float32)
           for n in "qkv"}
    params = perturbed_params(CFG, rng, key=9)
    ids = rng.integers(1, CFG.vocab_size, (2, 64)).astype(np.int32)
    y = rng.integers(0, CFG.vocab_size, (2, 64)).astype(np.int32)
    inp = {**{f"ring/{n}": a for n, a in qkv.items()},
           **flatten(params, "sp/p"), "sp/cfg": cfg_json(CFG),
           "sp/ids": ids, "sp/y": y}
    worker = start_worker("ring", inp, tmp, timeout=600)
    ref = {}
    jp = jax.tree.map(jnp.asarray, params)
    for n in WORLDS:
        mesh = _mesh(n)
        for dt, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            q, k, v = (jnp.asarray(qkv[c], jdt) for c in "qkv")
            for causal in (True, False):
                ref[(n, dt, causal)] = np.asarray(ring_attention(
                    q, k, v, mesh, causal=causal).astype(jnp.float32))
        ref[(n, "logits")] = np.asarray(forward_seq_parallel(
            jp, jnp.asarray(ids), CFG, mesh))

        def loss(p, mesh=mesh):
            total, count = masked_ce_sums(forward_seq_parallel(
                p, jnp.asarray(ids), CFG, mesh), jnp.asarray(y), 0)
            return total / jnp.maximum(count, 1)

        val, grads = jax.value_and_grad(loss)(jp)
        ref[(n, "loss")] = float(val)
        ref[(n, "grads")] = flatten(jax.tree.map(np.asarray, grads),
                                    "grads")
    return worker(), ref


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ring_attention_matches_jax(results, world, causal, dt):
    got, ref = results
    out = _joined(got, world, f"attn/{dt}/{causal}", 2)
    want = ref[(world, dt, causal)]
    if dt == "f32":
        np.testing.assert_allclose(out, want, atol=F32_ATOL, rtol=F32_RTOL)
    else:
        np.testing.assert_allclose(out, want, atol=BF16_ATOL, rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_forward_seq_parallel_matches_jax(results, world):
    got, ref = results
    np.testing.assert_allclose(_joined(got, world, "logits", 1),
                               ref[(world, "logits")], atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_seq_parallel_gradient_matches_jax(results, world):
    got, ref = results
    want = ref[(world, "loss")]
    for r in range(world):
        loss = float(got[f"w{world}/r{r}/loss"])
        assert abs(loss - want) <= LOSS_RTOL * want, (r, loss, want)
    grads = ref[(world, "grads")]
    scale = max(np.abs(g).max() for g in grads.values())
    for k, w in grads.items():
        g = got[f"w{world}/r0/{k}"]
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= GRAD_TOL * scale, k
