"""The port's GPipe pipeline against the JAX package's, on the CPU.

JAX runs ``eamg_tpu/parallel/pipeline.py`` here on the 8 virtual devices;
the port runs in one subprocess (tests/torch_port_worker.py, task
``pipeline``): a world of 1 in the subprocess itself, then spawned gloo
worlds of 4 and 2 ranks. The model is tests/test_pipeline.py's: d32, 4
heads, 4 layers, pre-LN gelu, causal, V 97; a batch of 8 x 16.

Checked, with the tolerance and its reason:
- ``stack_layers`` / ``unstack_layers`` round trip exactly; ``pp_pspecs``
  equals JAX's specs, tp off and on;
- ``pipeline_forward`` for each CASES mesh (1 stage; 2 stages x 4
  micro-batches; 4 x 2; DP x PP 2 x 2; 2 stages x a model axis of 2, the
  dp x pp x tp composition) against JAX's ``pipeline_forward`` on the
  same mesh: atol 2e-5, rtol 1e-4 (JAX's own test's tolerance: f32 sums
  in another order);
- two ``PipelineTrainer`` steps (the clip at 0.9 on) per case against
  JAX's ``PipelineTrainer``: losses within 1e-5 relative, the exported
  per-layer params within 5e-5 (JAX's own test's tolerance: a near-zero
  gradient puts Adam on the m / sqrt(v) knife edge) but for the K rows of
  each ``in_b`` (2 x the summed rate), which carry every gradient back
  through the stages;
- the 4-stage step's loss against JAX's plain ``Trainer`` (1e-5): the
  pipeline changes the layout, not the math;
- each rank holds its stage's layers, and ``shard_pp_params``' blocks
  have the shapes of JAX's shards;
- JAX's asserts as the port's errors: layers over stages, mixed MLP
  structures, B over n_micro, the micro-batch over the data axis,
  ``batch_first_bug``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

import jax
from jax.sharding import PartitionSpec as P

from eamg_tpu.models.gpt import GPTConfig
from eamg_tpu.parallel.pipeline import (PipelineTrainer, make_pp_mesh,
                                        pipeline_forward, pp_pspecs,
                                        shard_pp_params, stack_layers)
from eamg_tpu.train.trainer import TrainConfig, Trainer

from port_harness import cfg_json, flatten, perturbed_params, start_worker

CFG = GPTConfig(vocab_size=97, seq_len=32, d_model=32, n_head=4,
                n_layer=4, causal=True, ln_placement="pre",
                activation="gelu")
TCFG = TrainConfig(micro_batch=8, clip_norm=0.9)
CASES = {
    # name: (stages, data, model, n_micro)
    "s1": (1, 1, 1, 1),
    "s2m4": (2, 1, 1, 4),
    "s4m2": (4, 1, 1, 2),
    "d2s2": (2, 2, 1, 2),
    "s2tp2": (2, 1, 2, 2),
}
STEPS = 2
FWD_ATOL, FWD_RTOL = 2e-5, 1e-4
LOSS_RTOL, PARAM_TOL = 1e-5, 5e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(2424)
    tmp = tmp_path_factory.mktemp("pipeline")
    params = perturbed_params(CFG, rng, key=5)
    ids = rng.integers(0, CFG.vocab_size, (8, 16)).astype(np.int32)
    xs = rng.integers(1, CFG.vocab_size, (STEPS, 8, 16)).astype(np.int32)
    ys = rng.integers(1, CFG.vocab_size, (STEPS, 8, 16)).astype(np.int32)
    ys[:, :3, 10:] = 0                      # PAD targets, unequal by row
    inp = {**flatten(params, "pp/p"), "pp/cfg": cfg_json(CFG),
           "pp/ids": ids, "pp/x": xs, "pp/y": ys,
           "pp/mixed_mlp": np.asarray(json.dumps(
               [["b1", "b2", "w1", "w2"],
                ["b1", "b2", "router", "w1", "w2"]])),
           "pp/cases": np.asarray(json.dumps({
               name: {"stages": s, "data": d, "model": m, "n_micro": n,
                      "tcfg": dataclasses.asdict(TCFG), "forward": True,
                      "steps": STEPS}
               for name, (s, d, m, n) in CASES.items()}))}
    worker = start_worker("pipeline", inp, tmp, timeout=600)
    ref = {}
    for name, (s, d, m, n) in CASES.items():
        mesh = make_pp_mesh(s, data=d, model=m)
        stacked = shard_pp_params(stack_layers(params, s), mesh, tp=m > 1)
        ref[(name, "blocks")] = [
            list(a.sharding.shard_shape(a.shape))
            for a in jax.tree.leaves(stacked["layers"])]
        ref[(name, "logits")] = np.asarray(pipeline_forward(
            stacked, jax.numpy.asarray(ids), CFG, mesh, n))
        t = PipelineTrainer(CFG, TCFG, params, mesh, n_micro=n)
        ref[(name, "loss")] = [t.train_step(xs[i], ys[i])["loss"]
                               for i in range(STEPS)]
        ref[(name, "params")] = flatten(_np(t.export_params()),
                                        f"{name}/params")
    plain = Trainer(CFG, TCFG, params)
    ref["plain_loss"] = plain.train_step(xs[0][None], ys[0][None])["loss"]
    stacked = stack_layers(params, 2)
    for tp in (False, True):
        ref[("pspecs", tp)] = [list(sp) for sp in jax.tree.leaves(
            pp_pspecs(stacked, tp), is_leaf=lambda x: isinstance(x, P))]
    return worker(), ref


def _world(name):
    s, d, m, _ = CASES[name]
    return s * d * m


def test_stack_unstack_roundtrip(results):
    got, _ = results
    assert bool(got["roundtrip"])


@pytest.mark.parametrize("tp", [False, True])
def test_pp_pspecs_equal_jax(results, tp):
    got, ref = results
    assert json.loads(str(got[f"pp_pspecs/{tp}"])) == ref[("pspecs", tp)]


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_forward_matches_jax(results, name):
    got, ref = results
    np.testing.assert_allclose(got[f"w{_world(name)}/r0/{name}/logits"],
                               ref[(name, "logits")], atol=FWD_ATOL,
                               rtol=FWD_RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_trainer_matches_jax(results, name):
    got, ref = results
    p = f"w{_world(name)}/r0/{name}"
    np.testing.assert_allclose(got[f"{p}/loss"], ref[(name, "loss")],
                               rtol=LOSS_RTOL, atol=0)
    lr_sum = STEPS * float(np.float32(TCFG.lr))
    for k, w in ref[(name, "params")].items():
        g = got[f"w{_world(name)}/r0/{k}"]
        assert g.shape == w.shape, k
        if k.endswith("/attn/in_b"):
            ks = slice(CFG.d_model, CFG.d_model + CFG.kv_dim)
            rest = np.ones(w.shape, bool)
            rest[ks] = False
            np.testing.assert_allclose(g[rest], w[rest], rtol=0,
                                       atol=PARAM_TOL, err_msg=k)
            assert np.abs(g[ks] - w[ks]).max() <= 2 * lr_sum, k
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_TOL,
                                       err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_stage(results, name):
    got, ref = results
    s = CASES[name][0]
    for r in range(_world(name)):
        p = f"w{_world(name)}/r{r}/{name}"
        assert int(got[f"{p}/local_layers"]) == CFG.n_layer // s
        # shard_pp_params' blocks have JAX's shard shapes
        assert json.loads(str(got[f"{p}/block_shapes"])) == \
            ref[(name, "blocks")]


def test_pipeline_step_equals_the_plain_trainer(results):
    got, ref = results
    loss = float(got["w4/r0/s4m2/loss"][0])
    assert abs(loss - ref["plain_loss"]) <= LOSS_RTOL * ref["plain_loss"]


@pytest.mark.parametrize("what,needle", [
    ("layers", "not divisible by 3 stages"),
    ("mixed", "mixed MLP structures"),
    ("micro", "not divisible by n_micro=3"),
    ("data", "not divisible by the data axis"),
    ("batch_first", "batch_first_bug"),
])
def test_jax_asserts_are_the_port_errors(results, what, needle):
    got, _ = results
    msg = str(got[f"reject/{what}"])
    assert msg.startswith("ValueError") and needle in msg, msg
