"""The port's mesh modes against the JAX package, on the CPU: multi-process
init, the sharding specs, the DP / TP / FSDP trainer and their
compositions, a checkpoint written from a mesh, and ``cli train
--mesh-data / --mesh-model / --fsdp``.

JAX runs here on the 8 virtual CPU devices (tests/conftest.py); the port
runs in one subprocess (tests/torch_port_worker.py, task ``mesh``), which
spawns gloo ranks: a world of 4, a world of 2, and the CLI's own 4 ranks
(one process a rank, one thread each). Sizes are small: d32, 4 heads, 2
layers, T 15, V 48.

Checked, with the tolerance and its reason:
- ``init_distributed`` without an address is a no-op (world 1, rank 0);
  ``broadcast_bytes`` over 2 processes gives rank 0's bytes exactly;
- ``param_pspecs`` equals JAX's spec tree, entry for entry, for the
  flagship, large2 and an MoE large2, tp on and off, fsdp off, 2, 4, 8;
- three steps of each TRAINER_CASES (DP 2 and 4, TP 2 and 4 on GQA-2 and
  MHA, DP x TP 2 x 2, FSDP, MoE, the chunked CE under TP) against JAX's
  ``Trainer(mesh=)`` on the same mesh: the batches' rows hold unequal
  PAD, so the data shards hold unequal counts; losses within 1e-5
  relative, the step's target count equal, step 1's ``grad_norm`` (the
  clip at 0.8 on) within 1e-5 relative of the global norm of JAX's
  accumulated gradient, params within 1e-5 but for the K rows of each
  ``in_b`` (2 x the summed rate: tests/test_torch_train.py's scheme;
  sums over ranks run in another order);
- under FSDP each rank's param blocks have JAX's shard shapes, and its
  params plus both moments take exactly the bytes of JAX's shards (about
  1 / N of the sharded leaves);
- a DP step issues ONE all_reduce (``dist.all_reduce`` counted); the
  2-process DP steps equal the 1-process steps (1e-5 relative);
- at world size 1 the mesh trainer (tp and fsdp on) is bit-equal to the
  plain trainer: metrics, params and both moments, in bf16 and f32;
- a DP2 checkpoint resumed under TP2 takes JAX's uninterrupted third
  step, and JAX resumes that port checkpoint to the same step (as above);
- ``cli train --mesh-data 2 --mesh-model 2 --fsdp --device cpu`` against
  JAX's ``cli train`` with the same flags: the same summary keys, steps
  and vocabulary, each logged loss within 2e-4 (they are printed to 4
  places), the final loss within 1e-4 relative; ``--mesh-data 1
  --fsdp`` trains as one device to the same final loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from eamg_tpu.models.gpt import GPTConfig, init_params
from eamg_tpu.parallel.mesh import make_mesh, param_pspecs, shard_params
from eamg_tpu.train.trainer import (TrainConfig, Trainer, loss_fn,
                                    loss_fn_chunked, loss_fn_moe)
from eamg_tpu.utils.checkpoint import load_checkpoint

from port_harness import cfg_json, flatten, perturbed_params, start_worker

V, T = 48, 15
BASE = dict(vocab_size=V, seq_len=T + 1, d_model=32, n_head=4, n_layer=2,
            causal=True)
STEPS, ACCUM, MICRO = 3, 2, 4
CLIP = 0.8
# the cases of one variant share its params and batches (and so JAX's
# step-1 gradient, whatever the mesh)
VARIANTS = {"mha": {}, "gqa2": {"n_kv_heads": 2}, "moe": {"n_experts": 4}}
TRAINER_CASES = {
    # name: (data, model, fsdp, variant, loss_chunk)
    "dp4": (4, 1, False, "mha", None),
    "tp4_gqa2": (1, 4, False, "gqa2", None),
    "tp4_mha": (1, 4, False, "mha", None),
    "dp2tp2": (2, 2, False, "gqa2", 7),
    "dp2tp2_fsdp": (2, 2, True, "gqa2", None),
    "fsdp4": (4, 1, True, "mha", None),
    "dp2": (2, 1, False, "mha", None),
    "tp2_mha_chunked": (1, 2, False, "mha", 7),
    "tp2_moe": (1, 2, False, "moe", None),
    "dp2_moe": (2, 1, False, "moe", None),
}
FSDP_CASES = [n for n, c in TRAINER_CASES.items() if c[2]]
LOSS_RTOL, PARAM_TOL, NORM_RTOL = 1e-5, 1e-5, 1e-5
SPEC_CFGS = {
    "flagship": dict(vocab_size=8892, seq_len=512, d_model=512, n_head=8,
                     n_layer=6, n_kv_heads=2, causal=True),
    "large2": dict(vocab_size=8324, seq_len=512, d_model=512, n_head=8,
                   n_layer=6),
    "moe": dict(vocab_size=8324, seq_len=512, d_model=512, n_head=8,
                n_layer=6, n_experts=8, moe_every=2),
}
SPEC_CASES = [(c, tp, f) for c in SPEC_CFGS for tp in (False, True)
              for f in (None, 2, 4, 8)]
BIT_CASES = {
    "bf16_gqa2": (dict(dtype="bfloat16", n_kv_heads=2),
                  dict(clip_norm=0.9)),
    "f32_chunked": (dict(), dict(loss_chunk=7, schedule="warmup_cosine",
                                 warmup_steps=1, total_steps=5)),
}
CLI_ARGV = ["train", "--preset", "mini", "--corrected", "--synthetic", "16",
            "--epochs", "1", "--d-model", "32", "--n-head", "4",
            "--seq-len", "32", "--log-every", "1", "--mesh-data", "2",
            "--mesh-model", "2", "--fsdp"]


def _batches(rng, steps=STEPS, accum=ACCUM, micro=MICRO):
    """[steps, accum, micro, T] rows of unequal PAD (an all-PAD row and a
    nearly all-PAD row among them), shifted by one."""
    full = np.zeros((steps, accum, micro, T + 1), np.int32)
    for s in range(steps):
        for a in range(accum):
            for r in range(micro):
                n = int(rng.integers(2, T + 2))
                if (s + a + r) % 5 == 1:
                    n = 0
                elif (s + a + r) % 5 == 3:
                    n = 2
                full[s, a, r, :n] = rng.integers(1, V, n)
    return full[..., :-1], full[..., 1:]


def _tcfg(d, m, fsdp, chunk, **kw):
    return TrainConfig(micro_batch=MICRO, accum_steps=ACCUM, clip_norm=CLIP,
                       tp=m > 1, fsdp=fsdp, loss_chunk=chunk, **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_grad_norm(cfg, tcfg, params, x, y) -> float:
    """The global norm of JAX's accumulated step-1 gradient (the trainer's
    count-weighted sum over micro-batches)."""
    if tcfg.loss_chunk:
        def lfn(p, xi, yi):
            return loss_fn_chunked(p, xi, yi, cfg, 0, tcfg.loss_chunk)
    elif cfg.n_experts:
        def lfn(p, xi, yi):
            return loss_fn_moe(p, xi, yi, cfg, 0, tcfg.moe_aux_weight)
    else:
        def lfn(p, xi, yi):
            return loss_fn(p, xi, yi, cfg, 0)
    vg = jax.jit(jax.value_and_grad(lfn, has_aux=True))
    acc, total = None, 0
    for i in range(x.shape[0]):
        (_, count), g = vg(params, jnp.asarray(x[i]), jnp.asarray(y[i]))
        g = jax.tree.map(lambda a: a * count, g)
        acc = g if acc is None else jax.tree.map(jnp.add, acc, g)
        total += int(count)
    return float(optax.global_norm(jax.tree.map(lambda a: a / total, acc)))


def _spec_inputs(inp):
    cases = {}
    for c, tp, f in SPEC_CASES:
        shapes = jax.eval_shape(lambda: init_params(
            jax.random.PRNGKey(0), GPTConfig(**SPEC_CFGS[c])))
        tree = jax.tree.map(lambda s: list(s.shape), shapes)
        cases[f"{c}_{tp}_{f}"] = {"tree": tree, "tp": tp, "fsdp": f}
    inp["specs/cases"] = np.asarray(json.dumps(cases))


def _jax_specs(c, tp, f):
    shapes = jax.eval_shape(lambda: init_params(
        jax.random.PRNGKey(0), GPTConfig(**SPEC_CFGS[c])))
    specs = param_pspecs(shapes, tp, f)
    return [list(s) for s in jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, P))]


def _trainer_inputs(rng, inp) -> dict:
    cases, variants = {}, {}
    for i, (v, over) in enumerate(VARIANTS.items()):
        cfg = GPTConfig(**BASE, **over)
        variants[v] = (cfg, perturbed_params(cfg, rng, key=60 + i),
                       *_batches(rng))
    for name, (d, m, fsdp, v, chunk) in TRAINER_CASES.items():
        cfg, params, xs, ys = variants[v]
        tcfg = _tcfg(d, m, fsdp, chunk)
        p = f"tr/{name}"
        inp.update(flatten(params, f"{p}/p"))
        inp[f"{p}/cfg"] = cfg_json(cfg)
        inp[f"{p}/x"], inp[f"{p}/y"] = xs, ys
        cases[name] = {"d": d, "m": m, "tcfg": dataclasses.asdict(tcfg)}
    inp["tr/cases"] = np.asarray(json.dumps(cases))
    return variants


def _trainer_refs(variants, ref):
    norms = {}
    for name, (d, m, fsdp, v, chunk) in TRAINER_CASES.items():
        cfg, params, xs, ys = variants[v]
        tcfg = _tcfg(d, m, fsdp, chunk)
        if (v, chunk) not in norms:
            norms[(v, chunk)] = _jax_grad_norm(
                cfg, tcfg, jax.tree.map(jnp.asarray, params), xs[0], ys[0])
        mesh = make_mesh(data=d, model=m)
        t = Trainer(cfg, tcfg, params, mesh=mesh)
        ms = [t.train_step(xs[s], ys[s]) for s in range(STEPS)]
        ref[name] = {
            "loss": [m_["loss"] for m_ in ms],
            "tokens": [m_["tokens"] for m_ in ms],
            "norm1": norms[(v, chunk)],
            "params": flatten(_np(t.params), "params"), "cfg": cfg,
            "lr": float(np.float32(tcfg.lr)),
            "shard_shapes": [list(a.sharding.shard_shape(a.shape))
                             for a in jax.tree.leaves(shard_params(
                                 params, mesh, tp=m > 1, fsdp=fsdp))]}


def _bit_inputs(rng, inp):
    inp["bit/cases"] = np.asarray(json.dumps(list(BIT_CASES)))
    for i, (name, (over, tkw)) in enumerate(BIT_CASES.items()):
        cfg = GPTConfig(**BASE, **over)
        tcfg = TrainConfig(micro_batch=MICRO, accum_steps=ACCUM, tp=True,
                           fsdp=True, **tkw)
        p = f"bit/{name}"
        inp.update(flatten(perturbed_params(cfg, rng, key=80 + i),
                           f"{p}/p"))
        inp[f"{p}/cfg"] = cfg_json(cfg)
        inp[f"{p}/tcfg"] = np.asarray(json.dumps(dataclasses.asdict(tcfg)))
        inp[f"{p}/x"], inp[f"{p}/y"] = _batches(rng)


def _ckpt_inputs(rng, tmp, inp) -> tuple:
    cfg = GPTConfig(**BASE, n_kv_heads=2)
    tcfg = TrainConfig(micro_batch=MICRO, accum_steps=1)
    params = perturbed_params(cfg, rng, key=90)
    xs, ys = _batches(rng, accum=1)
    inp.update(flatten(params, "ckpt/p"))
    inp["ckpt/cfg"] = cfg_json(cfg)
    inp["ckpt/x"], inp["ckpt/y"] = xs, ys
    inp["ckpt/spec"] = np.asarray(json.dumps({
        "dir": str(tmp / "port_mesh_ckpt"),
        "tcfg": dataclasses.asdict(tcfg)}))
    return cfg, tcfg, params, xs, ys


def _ckpt_refs(cfg, tcfg, params, xs, ys, ref):
    t = Trainer(cfg, tcfg, params)
    ms = [t.train_step(xs[s], ys[s]) for s in range(STEPS)]
    ref["ckpt"] = {"loss": [m["loss"] for m in ms], "cfg": cfg,
                   "tcfg": tcfg, "x": xs, "y": ys,
                   "params": flatten(_np(t.params), "resume/params")}


def _jax_cli(tmp):
    from eamg_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(CLI_ARGV + ["--out", str(tmp / "jax_cli")])
    return buf.getvalue()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    rng = np.random.default_rng(1919)
    tmp = tmp_path_factory.mktemp("mesh")
    inp, ref = {}, {}
    _spec_inputs(inp)
    variants = _trainer_inputs(rng, inp)
    _bit_inputs(rng, inp)
    ckpt = _ckpt_inputs(rng, tmp, inp)
    inp["cli/argv"] = np.asarray(json.dumps(CLI_ARGV + ["--device", "cpu"]))
    # the port's side runs while JAX's is computed here
    worker = start_worker("mesh", inp, tmp, timeout=600)
    _trainer_refs(variants, ref)
    _ckpt_refs(*ckpt, ref)
    ref["cli"] = _jax_cli(tmp)
    got = worker()
    return got, ref, tmp


def _world(name):
    d, m = TRAINER_CASES[name][:2]
    return d * m


def _assert_params_close(cfg, got, want, lr_sum):
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k.endswith("/attn/in_b"):
            ks = slice(cfg.d_model, cfg.d_model + cfg.kv_dim)
            rest = np.ones(w.shape, bool)
            rest[ks] = False
            np.testing.assert_allclose(g[rest], w[rest], rtol=0,
                                       atol=PARAM_TOL, err_msg=k)
            assert np.abs(g[ks] - w[ks]).max() <= 2 * lr_sum, k
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_TOL,
                                       err_msg=k)


# --------------------------------------------------------------- multihost

def test_init_distributed_without_an_address_is_a_no_op(results):
    got, _, _ = results
    assert not bool(got["noop/initialized"])
    assert bool(got["noop/main"])
    assert got["noop/bcast"].tobytes() == b"solo"


@pytest.mark.parametrize("rank", [0, 1])
def test_broadcast_bytes_two_processes(results, rank):
    got, _, _ = results
    assert got[f"w2/r{rank}/bcast"].tobytes() == b"[PAD] [START] vocab"


# ------------------------------------------------------------------ specs

@pytest.mark.parametrize("case,tp,fsdp", SPEC_CASES)
def test_param_pspecs_equal_jax(results, case, tp, fsdp):
    got, _, _ = results
    assert json.loads(str(got[f"specs/{case}_{tp}_{fsdp}"])) == \
        _jax_specs(case, tp, fsdp)


# ---------------------------------------------------------------- trainer

@pytest.mark.parametrize("name", list(TRAINER_CASES))
def test_mesh_trainer_matches_jax(results, name):
    got, ref, _ = results
    r = ref[name]
    p = f"w{_world(name)}/r0/{name}"
    np.testing.assert_allclose(got[f"{p}/loss"], r["loss"], rtol=LOSS_RTOL,
                               atol=0)
    assert list(got[f"{p}/tokens"]) == r["tokens"]
    norm = float(got[f"{p}/grad_norm"][0])
    assert abs(norm - r["norm1"]) <= NORM_RTOL * r["norm1"], (norm,
                                                              r["norm1"])
    _assert_params_close(r["cfg"], {k: got[f"{p}/{k}"] for k in r["params"]},
                         r["params"], STEPS * r["lr"])


@pytest.mark.parametrize("name", FSDP_CASES)
def test_fsdp_blocks_are_jax_shards(results, name):
    got, ref, _ = results
    world = _world(name)
    want = ref[name]["shard_shapes"]
    nbytes = 3 * 4 * sum(int(np.prod(s)) for s in want)
    full = 3 * 4 * sum(int(np.prod(v.shape))
                       for v in ref[name]["params"].values())
    for r in range(world):
        p = f"w{world}/r{r}/{name}"
        assert json.loads(str(got[f"{p}/local_shapes"])) == want
        assert int(got[f"{p}/local_bytes"]) == nbytes
        assert nbytes < full / world * 1.25, (nbytes, full)


def test_a_dp_step_issues_one_all_reduce(results):
    got, _, _ = results
    for r in range(2):
        assert int(got[f"w2/r{r}/count/all_reduce"]) == 1


def test_two_process_dp_equals_one_process(results):
    got, _, _ = results
    np.testing.assert_allclose(got["w2/r0/dp2/loss"],
                               got["dp2_one_process/loss"], rtol=LOSS_RTOL)


@pytest.mark.parametrize("name", list(BIT_CASES))
@pytest.mark.parametrize("what", ["metrics", "params", "moments"])
def test_world_one_mesh_step_is_bit_equal_to_plain(results, name, what):
    got, _, _ = results
    assert bool(got[f"bit/{name}/{what}_equal"])


# ------------------------------------------------------------- checkpoint

def test_dp2_checkpoint_resumed_under_tp2_continues(results):
    got, ref, _ = results
    r = ref["ckpt"]
    assert int(got["w2/r0/resume/step"]) == 3
    assert abs(float(got["w2/r0/resume/loss"]) - r["loss"][2]) <= \
        LOSS_RTOL * abs(r["loss"][2])
    _assert_params_close(r["cfg"], {k: got[f"w2/r0/{k}"]
                                    for k in r["params"]}, r["params"],
                         STEPS * float(np.float32(r["tcfg"].lr)))


def test_jax_resumes_the_port_mesh_checkpoint(results):
    _, ref, tmp = results
    r = ref["ckpt"]
    ck = load_checkpoint(str(tmp / "port_mesh_ckpt"))
    assert ck["step"] == 2 and ck["cfg"] == r["cfg"]
    t = Trainer(r["cfg"], r["tcfg"], ck["params"])
    t.opt_state = jax.tree.map(
        lambda x: jnp.asarray(x) if hasattr(x, "shape") else x,
        ck["opt_state"])
    t.step = ck["step"]
    m = t.train_step(r["x"][2], r["y"][2])
    assert abs(m["loss"] - r["loss"][2]) <= LOSS_RTOL * abs(r["loss"][2])
    _assert_params_close(r["cfg"], flatten(_np(t.params), "resume/params"),
                         r["params"], STEPS * float(np.float32(
                             r["tcfg"].lr)))


# -------------------------------------------------------------------- CLI

def _logged(text: str) -> list:
    return [float(v) for v in re.findall(r"step \d+: loss=([0-9.]+)", text)]


def _summary(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def test_cli_mesh_train_matches_jax_cli(results):
    got, ref, _ = results
    assert int(got["cli/code"]) == 0, str(got["cli/stderr"])
    port, jax_out = str(got["cli/stdout"]), ref["cli"]
    a, b = _summary(port), _summary(jax_out)
    assert set(a) == set(b)
    assert a["steps"] == b["steps"] and a["vocab_size"] == b["vocab_size"]
    assert abs(a["final_loss"] - b["final_loss"]) <= 1e-4 * b["final_loss"]
    la, lb = _logged(port), _logged(jax_out)
    assert len(la) == len(lb) == a["steps"]
    np.testing.assert_allclose(la, lb, rtol=0, atol=2e-4)


def test_cli_fsdp_with_a_data_axis_of_one_trains_as_one_device(results):
    got, ref, _ = results
    assert int(got["cli_one/code"]) == 0
    a, b = _summary(str(got["cli_one/stdout"])), _summary(ref["cli"])
    assert a["steps"] == b["steps"]
    assert abs(a["final_loss"] - b["final_loss"]) <= 1e-4 * b["final_loss"]
