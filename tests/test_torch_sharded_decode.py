"""Tensor-parallel decoding in the port against the JAX package, on the
CPU: ``decode/loop.py::generate_kv`` on TP-sharded params.

JAX decodes here with ``shard_params(tp=True)`` on a (4 data x 2 model)
mesh of virtual devices (tests/test_sharded_serving.py); the port runs in
one subprocess (tests/torch_port_worker.py, task ``sharded_decode``): a
model group of 1 in the subprocess itself, then spawned gloo groups of 2
and 4 ranks, each rank holding its heads (a K/V head shared by 2 ranks in
the GQA-2 model at 4), its FF columns and its vocabulary rows
(``parallel/mesh.py::shard_params``), running the prefill and every step
on them with the logits gathered whole before the sampler.

Checked, exactly (f32; every rank of a group):
- the greedy stream equals the port's unsharded stream and JAX's stream
  on its TP-sharded params;
- the sampled stream (top-k 50, a threefry key) equals the port's
  unsharded sampled stream;
- the positions returned equal.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from eamg_tpu.decode import generate_kv
from eamg_tpu.models import GPTConfig, init_params
from eamg_tpu.parallel import make_mesh, shard_params

from port_harness import cfg_json, flatten, start_worker

BASE = dict(vocab_size=96, seq_len=32, d_model=32, n_head=4, n_layer=2,
            pos_rows=32, ln_placement="pre", activation="gelu", causal=True)
CASES = {"mha": {}, "gqa2": {"n_kv_heads": 2}}
WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_decode")
    prompt = np.zeros((2, 8), np.int32)
    prompt[:, :3] = [[1, 2, 3]]
    inp = {"dec/prompt": prompt,
           "dec/cases": np.asarray(json.dumps(list(CASES)))}
    params = {}
    for i, (name, over) in enumerate(CASES.items()):
        cfg = GPTConfig(**BASE, **over)
        params[name] = (cfg, init_params(jax.random.PRNGKey(i), cfg))
        inp.update(flatten(jax.tree.map(np.asarray, params[name][1]),
                           f"dec/{name}/p"))
        inp[f"dec/{name}/cfg"] = cfg_json(cfg)
    worker = start_worker("sharded_decode", inp, tmp, timeout=600)
    ref = {}
    mesh = make_mesh(data=4, model=2)
    for name, (cfg, p) in params.items():
        buf, pos = generate_kv(shard_params(p, mesh, tp=True),
                               jnp.asarray(prompt), 3,
                               jax.random.PRNGKey(0), cfg, 24, greedy=True,
                               eos_id=-1, pad_id=0, refeed_last_prompt=False)
        ref[name] = (np.asarray(buf), int(pos))
    return worker(), ref


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_tp_greedy_stream_equals_jax_and_unsharded(results, world, name):
    got, ref = results
    want, pos = ref[name]
    for r in range(world):
        p = f"w{world}/r{r}/{name}/True"
        np.testing.assert_array_equal(got[f"{p}/tp"], want)
        np.testing.assert_array_equal(got[f"{p}/one"], want)
        assert list(got[f"{p}/pos"]) == [pos, pos]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_tp_sampled_stream_equals_unsharded(results, world, name):
    got, _ = results
    for r in range(world):
        p = f"w{world}/r{r}/{name}/False"
        np.testing.assert_array_equal(got[f"{p}/tp"], got[f"{p}/one"])


def test_a_kv_head_is_shared_where_the_group_outnumbers_them(results):
    got, _ = results
    assert int(got["w4/r0/gqa2/kv_heads"]) == 1
    assert int(got["w2/r0/gqa2/kv_heads"]) == 1
    assert int(got["w2/r0/mha/kv_heads"]) == 2
