"""The PyTorch side of the parallel modes' tests (tests/test_torch_mesh.py,
test_torch_pipeline.py, test_torch_ring.py, test_torch_ep.py,
test_torch_sharded_decode.py, test_torch_sharded_engine.py): one task a
file, run by
tests/torch_port_worker.py in its subprocess (torch never enters the
pytest process). Each task spawns its worlds of gloo ranks on the CPU (at
most 4 ranks, one thread each, a rendezvous file of their own and a
collective timeout), every rank reading the same .npz; each rank's results
come back to the task through a pickle file."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import torch

from torch_port_worker import CPU, _cfg, _raised, unflatten

os.environ.setdefault("EAMG_DIST_TIMEOUT", "180")


# ------------------------------------------------------------ the worlds

def _rank_entry(rank: int, world: int, path: str, tmp: str, fn: str,
                tag: str) -> None:
    import torch.distributed as dist

    from eamg_tpu_torch.parallel.multihost import init_distributed

    torch.set_num_threads(1)
    init_distributed(init_method=f"file://{tmp}/{tag}.rdv",
                     num_processes=world, process_id=rank, device=CPU)
    try:
        with np.load(path, allow_pickle=False) as inp:
            res = globals()[fn](rank, world, inp, tmp)
        _keep(res, tmp, fn, world, rank)
    finally:
        dist.destroy_process_group()


def _keep(res: dict, tmp: str, fn: str, world: int, rank: int) -> None:
    """Write a rank's results where :func:`spawn` reads them."""
    with open(os.path.join(tmp, f"{fn}{world}.{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def spawn(fn: str, world: int, inp, tmp: str) -> list:
    """Run ``fn(rank, world, inp, tmp)`` on ``world`` gloo ranks -> the
    ranks' results in rank order."""
    import torch.multiprocessing as mp

    path = os.path.join(tmp, "inputs.npz")
    if not os.path.exists(path):
        np.savez(path, **{k: inp[k] for k in inp.files})
    tag = f"{fn}{world}"
    mp.start_processes(_rank_entry, args=(world, path, tmp, fn, tag),
                       nprocs=world, start_method="spawn")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{tag}.{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _one_rank_world(tmp: str, tag: str):
    """Join a process group of one (this process) -> a context that leaves
    it."""
    import torch.distributed as dist

    from eamg_tpu_torch.parallel.multihost import init_distributed

    init_distributed(init_method=f"file://{tmp}/{tag}.rdv", num_processes=1,
                     process_id=0, device=CPU)

    @contextlib.contextmanager
    def held():
        try:
            yield
        finally:
            dist.destroy_process_group()

    return held()


def _params(inp, prefix):
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    return params_from_jax(unflatten(inp, prefix))


def _leaves(tree, prefix: str) -> dict:
    """A tree of tensors -> {"prefix/a/0/b": float32 numpy}."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            out[path] = node.detach().float().cpu().numpy()

    walk(tree, prefix)
    return out


def _tcfg(d: dict):
    from eamg_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(**d)


def _metrics(ms: list) -> dict:
    return {k: np.asarray([m[k] for m in ms], np.float64)
            for k in ms[0] if k in ("loss", "tokens", "grad_norm")}


def _merge(out: dict, prefix: str, res: dict) -> None:
    for k, v in res.items():
        out[f"{prefix}/{k}"] = np.asarray(v)


# ------------------------------------------------------------------ mesh

def _meta_tree(node):
    if isinstance(node, dict):
        return {k: _meta_tree(v) for k, v in node.items()}
    if isinstance(node, list) and node and isinstance(node[0], dict):
        return [_meta_tree(v) for v in node]
    return torch.empty(tuple(node), device="meta")


def _spec_checks(inp, out) -> None:
    from eamg_tpu_torch.parallel.mesh import _walk_specs, param_pspecs

    for name, case in json.loads(str(inp["specs/cases"])).items():
        tree = _meta_tree(case["tree"])
        specs = param_pspecs(tree, case["tp"], case["fsdp"])
        out[f"specs/{name}"] = np.asarray(json.dumps(
            [list(s) for _, s in _walk_specs(specs)]))


def _train_case(rank, inp, name, case) -> dict:
    from eamg_tpu_torch.parallel.mesh import make_mesh
    from eamg_tpu_torch.train.trainer import Trainer, tree_leaves

    p = f"tr/{name}"
    cfg = _cfg(inp, f"{p}/cfg")
    tcfg = _tcfg(case["tcfg"])
    mesh = make_mesh(case["d"], case["m"])
    t = Trainer(cfg, tcfg, _params(inp, f"{p}/p"), device=CPU, mesh=mesh)
    xs, ys = inp[f"{p}/x"], inp[f"{p}/y"]
    ms = [t.train_step(xs[s], ys[s]) for s in range(xs.shape[0])]
    res = {"local_bytes": sum(a.numel() * a.element_size() for a in
                              tree_leaves(t.params) + t.opt_state["mu"]
                              + t.opt_state["nu"]),
           "local_shapes": json.dumps([list(a.shape)
                                       for a in tree_leaves(t.params)])}
    full = t.export_params()
    if rank == 0:
        res.update(_metrics(ms))
        res.update(_leaves(full, "params"))
    return res


def mesh_world(rank: int, world: int, inp, tmp: str) -> dict:
    """The trainer cases of ``world`` ranks; with 2 ranks also the
    collective count of a DP step, broadcast_bytes and the resume of a DP2
    checkpoint under TP2."""
    import torch.distributed as dist

    from eamg_tpu_torch.parallel import multihost
    from eamg_tpu_torch.parallel.mesh import make_mesh
    from eamg_tpu_torch.train.trainer import Trainer
    from eamg_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 save_checkpoint)

    res = {}
    for name, case in json.loads(str(inp["tr/cases"])).items():
        if case["d"] * case["m"] == world:
            _merge(res, name, _train_case(rank, inp, name, case))
    if world != 2:
        return res
    # one all_reduce a DP step (no clip): dist.all_reduce counted
    cfg = _cfg(inp, "tr/dp2/cfg")
    case = json.loads(str(inp["tr/cases"]))["dp2"]
    t = Trainer(cfg, _tcfg({**case["tcfg"], "clip_norm": None}),
                _params(inp, "tr/dp2/p"), device=CPU, mesh=make_mesh(2, 1))
    calls = {"all_reduce": 0, "other": 0}
    real = dist.all_reduce

    def counted(*a, **k):
        calls["all_reduce"] += 1
        return real(*a, **k)

    dist.all_reduce = counted
    try:
        t.train_step(inp["tr/dp2/x"][0], inp["tr/dp2/y"][0])
    finally:
        dist.all_reduce = real
    res["count/all_reduce"] = calls["all_reduce"]
    res["bcast"] = np.frombuffer(multihost.broadcast_bytes(
        b"[PAD] [START] vocab" if rank == 0 else None, 64), np.uint8)
    # DP2 for 2 steps, rank 0 writes the checkpoint, TP2 resumes it
    ck = json.loads(str(inp["ckpt/spec"]))
    tcfg = _tcfg(ck["tcfg"])
    ccfg = _cfg(inp, "ckpt/cfg")
    xs, ys = inp["ckpt/x"], inp["ckpt/y"]
    t = Trainer(ccfg, tcfg, _params(inp, "ckpt/p"), device=CPU,
                mesh=make_mesh(2, 1))
    for s in range(2):
        t.train_step(xs[s], ys[s])
    params, opt = t.checkpoint_trees()
    if rank == 0:
        save_checkpoint(ck["dir"], params, {"t": 0}, ccfg, opt_state=opt,
                        step=t.step, tcfg=tcfg)
    dist.barrier()
    loaded = load_checkpoint(ck["dir"])
    t2 = Trainer(ccfg, dataclasses.replace(tcfg, tp=True), loaded["params"],
                 device=CPU, mesh=make_mesh(1, 2))
    t2.load_opt_state(loaded["opt_state"])
    t2.step = loaded["step"]
    m = t2.train_step(xs[2], ys[2])
    full = t2.export_params()
    if rank == 0:
        res["resume/loss"] = m["loss"]
        res["resume/step"] = t2.step
        res.update(_leaves(full, "resume/params"))
    return res


def _bit_equal_checks(inp, out, tmp) -> None:
    """World 1: the mesh trainer (1 x 1, tp and fsdp on) against the plain
    one, bit for bit."""
    from eamg_tpu_torch.parallel.mesh import make_mesh
    from eamg_tpu_torch.train.trainer import Trainer, tree_leaves

    with _one_rank_world(tmp, "bit"):
        for name in json.loads(str(inp["bit/cases"])):
            p = f"bit/{name}"
            cfg, tcfg = _cfg(inp, f"{p}/cfg"), _tcfg(json.loads(str(
                inp[f"{p}/tcfg"])))
            params = _params(inp, f"{p}/p")
            a = Trainer(cfg, tcfg, params, device=CPU, mesh=make_mesh(1, 1))
            b = Trainer(cfg, tcfg, params, device=CPU)
            xs, ys = inp[f"{p}/x"], inp[f"{p}/y"]
            ma = [a.train_step(xs[s], ys[s]) for s in range(xs.shape[0])]
            mb = [b.train_step(xs[s], ys[s]) for s in range(xs.shape[0])]
            out[f"{p}/metrics_equal"] = np.asarray(ma == mb)
            out[f"{p}/params_equal"] = np.asarray(all(
                torch.equal(u, v) for u, v in zip(
                    tree_leaves(a.export_params()), tree_leaves(b.params))))
            out[f"{p}/moments_equal"] = np.asarray(all(
                torch.equal(u, v) for u, v in zip(
                    a.opt_state["mu"] + a.opt_state["nu"],
                    b.opt_state["mu"] + b.opt_state["nu"])))


def _cli(argv) -> tuple:
    from eamg_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            code = cli.main(argv)
        except SystemExit as e:
            code = e.code
    return code, buf.getvalue()


def task_mesh(inp, out) -> None:
    """tests/test_torch_mesh.py."""
    import torch.distributed as dist

    from eamg_tpu_torch.parallel import multihost
    from eamg_tpu_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp()
    for k in ("MASTER_ADDR", "MASTER_PORT", "JAX_COORDINATOR_ADDRESS"):
        os.environ.pop(k, None)
    multihost.init_distributed()
    out["noop/initialized"] = np.asarray(dist.is_initialized())
    out["noop/main"] = np.asarray(multihost.is_main_process())
    out["noop/bcast"] = np.frombuffer(multihost.broadcast_bytes(b"solo"),
                                      np.uint8)
    _spec_checks(inp, out)
    _bit_equal_checks(inp, out, tmp)
    for world in (4, 2):
        for r, res in enumerate(spawn("mesh_world", world, inp, tmp)):
            _merge(out, f"w{world}/r{r}", res)
    # the 1-process step of the DP2 case, for the 2-process comparison
    case = json.loads(str(inp["tr/cases"]))["dp2"]
    t = Trainer(_cfg(inp, "tr/dp2/cfg"), _tcfg(case["tcfg"]),
                _params(inp, "tr/dp2/p"), device=CPU)
    xs, ys = inp["tr/dp2/x"], inp["tr/dp2/y"]
    out["dp2_one_process/loss"] = np.asarray(
        [t.train_step(xs[s], ys[s])["loss"] for s in range(xs.shape[0])])
    # the CLI: 4 spawned ranks (a subprocess, whose ranks print), and a
    # mesh of one with --fsdp in this process
    argv = json.loads(str(inp["cli/argv"]))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_"))}
    proc = subprocess.run([sys.executable, "-m", "eamg_tpu_torch.cli",
                           *argv, "--out", os.path.join(tmp, "cli_mesh")],
                          capture_output=True, text=True, timeout=300,
                          env=env)
    out["cli/code"] = np.asarray(proc.returncode)
    out["cli/stdout"] = np.asarray(proc.stdout)
    out["cli/stderr"] = np.asarray(proc.stderr[-3000:])
    one = list(argv)
    one[one.index("--mesh-data") + 1] = "1"
    one[one.index("--mesh-model") + 1] = "1"
    code, text = _cli(one + ["--out", os.path.join(tmp, "cli_one")])
    out["cli_one/code"], out["cli_one/stdout"] = np.asarray(code), \
        np.asarray(text)


# -------------------------------------------------------------- pipeline

def pipeline_world(rank: int, world: int, inp, tmp: str) -> dict:
    from eamg_tpu_torch.parallel.mesh import _walk
    from eamg_tpu_torch.parallel.pipeline import (PipelineTrainer,
                                                  make_pp_mesh,
                                                  pipeline_forward,
                                                  shard_pp_params,
                                                  stack_layers)

    res = {}
    cfg = _cfg(inp, "pp/cfg")
    params = _params(inp, "pp/p")
    ids = torch.from_numpy(inp["pp/ids"])
    for name, case in json.loads(str(inp["pp/cases"])).items():
        S, d, m = case["stages"], case["data"], case["model"]
        if S * d * m != world:
            continue
        mesh = make_pp_mesh(S, data=d, model=m)
        block = shard_pp_params(stack_layers(params, S), mesh, tp=m > 1,
                                cfg=cfg)
        res[f"{name}/block_shapes"] = json.dumps(
            [list(a.shape) for _, a in _walk(block["layers"])])
        tcfg = _tcfg(case["tcfg"])
        t = PipelineTrainer(cfg, tcfg, params, mesh, case["n_micro"],
                            device=CPU)
        if case.get("forward"):
            logits = pipeline_forward(t.params, ids, cfg, mesh,
                                      case["n_micro"])
            if rank == 0:
                res[f"{name}/logits"] = logits.numpy()
        if case.get("steps"):
            xs, ys = inp["pp/x"], inp["pp/y"]
            ms = [t.train_step(xs[s], ys[s]) for s in range(case["steps"])]
            full = t.export_params()
            if rank == 0:
                _merge(res, name, _metrics(ms))
                res.update(_leaves(full, f"{name}/params"))
        res[f"{name}/local_layers"] = len(t.params["layers"])
    return res


def task_pipeline(inp, out) -> None:
    """tests/test_torch_pipeline.py."""
    from eamg_tpu_torch.models.gpt import GPTConfig
    from eamg_tpu_torch.parallel.pipeline import (_check_cfg, _check_layers,
                                                  _micro_rows, pp_pspecs,
                                                  stack_layers,
                                                  unstack_layers)

    tmp = tempfile.mkdtemp()
    params = _params(inp, "pp/p")
    cfg = _cfg(inp, "pp/cfg")
    back = unstack_layers(stack_layers(params, 2))
    a, b = _leaves(params, ""), _leaves(back, "")
    out["roundtrip"] = np.asarray(a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a))
    stacked = stack_layers(params, 2)
    for tp in (False, True):
        from eamg_tpu_torch.parallel.mesh import _walk_specs

        out[f"pp_pspecs/{tp}"] = np.asarray(json.dumps(
            [list(s) for _, s in _walk_specs(pp_pspecs(stacked, tp))]))
    moe = json.loads(str(inp["pp/mixed_mlp"]))
    out["reject/layers"] = _raised(lambda: stack_layers(params, 3))
    out["reject/mixed"] = _raised(lambda: _check_layers(
        [{"mlp": {k: 0 for k in m}} for m in moe], 1))
    ids = torch.from_numpy(inp["pp/ids"])
    out["reject/micro"] = _raised(lambda: _micro_rows(ids, 3, 1, 0))
    out["reject/data"] = _raised(lambda: _micro_rows(ids, 8, 2, 0))
    out["reject/batch_first"] = _raised(lambda: _check_cfg(
        GPTConfig(**{**cfg.__dict__, "batch_first_bug": True})))
    with _one_rank_world(tmp, "pp1"):
        _merge(out, "w1/r0", pipeline_world(0, 1, inp, tmp))
    for world in (4, 2):
        for r, res in enumerate(spawn("pipeline_world", world, inp, tmp)):
            _merge(out, f"w{world}/r{r}", res)


# ------------------------------------------------------------------ ring

def ring_world(rank: int, world: int, inp, tmp: str) -> dict:
    import torch.distributed as dist

    from eamg_tpu_torch.parallel.collectives import all_reduce_
    from eamg_tpu_torch.parallel.ring_attention import (forward_seq_parallel,
                                                        ring_attention,
                                                        seq_parallel_loss)
    from eamg_tpu_torch.train.trainer import tree_leaves, tree_unflatten

    G = dist.group.WORLD
    res = {}
    for dt in ("f32", "bf16"):
        q, k, v = (torch.from_numpy(inp[f"ring/{n}"]) for n in "qkv")
        if dt == "bf16":
            q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
        for causal in (True, False):
            res[f"attn/{dt}/{causal}"] = ring_attention(
                q, k, v, G, causal).float().numpy()
    cfg = _cfg(inp, "sp/cfg")
    params = _params(inp, "sp/p")
    ids = torch.from_numpy(inp["sp/ids"])
    with torch.no_grad():
        res["logits"] = forward_seq_parallel(params, ids, cfg, G).numpy()
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss, count = seq_parallel_loss(tree_unflatten(params, live), ids,
                                    torch.from_numpy(inp["sp/y"]), cfg, G, 0)
    grads = list(torch.autograd.grad(loss, live))
    all_reduce_(grads, G)
    res["loss"] = float(loss)
    if rank == 0:
        res.update(_leaves(tree_unflatten(params, grads), "grads"))
    return res


def task_ring(inp, out) -> None:
    """tests/test_torch_ring.py."""
    tmp = tempfile.mkdtemp()
    for world in (4, 2):
        for r, res in enumerate(spawn("ring_world", world, inp, tmp)):
            _merge(out, f"w{world}/r{r}", res)


# -------------------------------------------------------------------- ep

def ep_world(rank: int, world: int, inp, tmp: str) -> dict:
    import torch.distributed as dist

    from eamg_tpu_torch.parallel.moe import (MoEConfig, moe_mlp_ep,
                                             shard_moe_params)

    G = dist.group.WORLD
    mcfg = MoEConfig(**json.loads(str(inp["ep/mcfg"])))
    params = _params(inp, "ep/p")
    x = torch.from_numpy(inp["ep/x"])
    N = x.shape[0] * x.shape[1]
    n = N // world
    mine = x.reshape(N, -1)[rank * n:(rank + 1) * n]
    res = {}
    for name, cap in json.loads(str(inp["ep/caps"]))[str(world)].items():
        cap = cap if cap else None
        local = {k: v.detach().requires_grad_()
                 for k, v in shard_moe_params(params, G).items()}
        xl = mine.clone().requires_grad_()
        y = moe_mlp_ep(local, xl, mcfg, G, capacity=cap)
        w = torch.from_numpy(inp["ep/w"]).reshape(N, -1)[rank * n:(rank + 1)
                                                         * n]
        (y * w).sum().backward()
        res[f"{name}/y"] = y.detach().numpy()
        res[f"{name}/dx"] = xl.grad.numpy()
        router = local["router"].grad.clone()
        dist.all_reduce(router, group=G)
        res[f"{name}/router"] = router.numpy()
        for k in ("w1", "b1", "w2", "b2"):
            res[f"{name}/{k}"] = local[k].grad.numpy()
    return res


def task_ep(inp, out) -> None:
    """tests/test_torch_ep.py."""
    tmp = tempfile.mkdtemp()
    for world in (4, 2):
        for r, res in enumerate(spawn("ep_world", world, inp, tmp)):
            _merge(out, f"w{world}/r{r}", res)


# ---------------------------------------------------------- sharded decode

def decode_world(rank: int, world: int, inp, tmp: str) -> dict:
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.parallel.collectives import tensor_parallel
    from eamg_tpu_torch.parallel.mesh import make_mesh, shard_params
    from eamg_tpu_torch.utils import prng

    res = {}
    prompt = torch.from_numpy(inp["dec/prompt"]).long()
    for name in json.loads(str(inp["dec/cases"])):
        cfg = _cfg(inp, f"dec/{name}/cfg")
        params = _params(inp, f"dec/{name}/p")
        mesh = make_mesh(1, world)
        tp = tensor_parallel(cfg, mesh.get_group("model"))
        blocks = shard_params(params, mesh, tp=True, cfg=cfg)
        for greedy in (True, False):
            buf, pos = generate_kv(blocks, prompt, 3, prng.PRNGKey(7), cfg,
                                   24, greedy=greedy, eos_id=-1, pad_id=0,
                                   refeed_last_prompt=False, tp=tp)
            one, pos1 = generate_kv(params, prompt, 3, prng.PRNGKey(7), cfg,
                                    24, greedy=greedy, eos_id=-1, pad_id=0,
                                    refeed_last_prompt=False)
            res[f"{name}/{greedy}/tp"] = buf.numpy()
            res[f"{name}/{greedy}/one"] = one.numpy()
            res[f"{name}/{greedy}/pos"] = np.asarray([pos, pos1])
            res[f"{name}/kv_heads"] = tp.kv_heads
    return res


def task_sharded_decode(inp, out) -> None:
    """tests/test_torch_sharded_decode.py."""
    tmp = tempfile.mkdtemp()
    with _one_rank_world(tmp, "dec1"):
        _merge(out, "w1/r0", decode_world(0, 1, inp, tmp))
    for world in (2, 4):
        for r, res in enumerate(spawn("decode_world", world, inp, tmp)):
            _merge(out, f"w{world}/r{r}", res)


# ---------------------------------------------------------- sharded engine

def _engine_run(gen, spec, engine: str, gram) -> tuple:
    """One engine of ``spec["engines"]`` on ``gen``: on a leader (or
    alone) the requests' rows, request 1 submitted once the first chunk
    ran; on a follower its loop. -> (rows or None, [chunks when request 1
    was submitted, chunks in all] or None, the engine's final state)."""
    import threading
    import time

    from eamg_tpu_torch.serve.continuous import ContinuousBatcher

    eng_opts, row_opts = spec["engines"][engine]
    eng_opts = dict(eng_opts)
    if eng_opts.pop("grammar", False):
        eng_opts["grammar"] = gram
    eng = ContinuousBatcher(gen, slots=spec["slots"], chunk=spec["chunk"],
                            max_len=spec["max_len"], top_k=spec["top_k"],
                            **eng_opts)
    if not eng.leader:
        eng.serve_follower()
        return None, None, eng.state
    rows, joined = {}, []

    def hit(i):
        ids, seed, temp = spec["requests"][i]
        kw = dict(spec["opts"][row_opts[i]])
        if "penalties" in kw:
            kw["penalties"] = tuple(kw["penalties"])
        rows[i] = eng.submit(ids, temperature=temp, seed=seed, timeout=600,
                             **kw)

    try:
        threads = [threading.Thread(target=hit, args=(i,), daemon=True)
                   for i in range(len(spec["requests"]))]
        threads[0].start()
        deadline = time.monotonic() + 600
        while eng.stats["chunks"] < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        joined.append(eng.stats["chunks"])
        for t in threads[1:]:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert len(rows) == len(spec["requests"]), "a request timed out"
        joined.append(eng.stats["chunks"])
    finally:
        eng.close()
    return [rows[i] for i in range(len(rows))], joined, eng.state


def _engine_results(gen, spec, case: str, gram, res: dict) -> None:
    for c, engine in spec["engine_cases"]:
        if c != case:
            continue
        rows, joined, state = _engine_run(gen, spec, engine, gram)
        pre = f"{case}/{engine}"
        for key in ("buf", "pos", "done", "last"):
            res[f"{pre}/state/{key}"] = state[key].numpy().copy()
        res[f"{pre}/state/rngs"] = np.asarray(state["rngs"]).copy()
        if rows is not None:
            for i, row in enumerate(rows):
                res[f"{pre}/{i}"] = np.asarray(row)
            res[f"{pre}/joined_at"] = np.asarray(joined)


def _ragged_rows(gen, spec, tp=None) -> np.ndarray:
    from eamg_tpu_torch.decode.ragged import generate_kv_ragged
    from eamg_tpu_torch.utils import prng

    reqs = spec["requests"]
    prompt = torch.zeros((len(reqs), 8), dtype=torch.int64)
    for i, (ids, _, _) in enumerate(reqs):
        prompt[i, :len(ids)] = torch.tensor(ids)
    buf, _ = generate_kv_ragged(
        gen.params, prompt, [len(r[0]) for r in reqs],
        prng.key_rows([s for _, s, _ in reqs]), gen.cfg, spec["max_len"],
        top_k=spec["top_k"], eos_id=-1, pad_id=0, tp=tp)
    return buf.numpy()


def _engine_generator(inp, case: str, params, tp=None):
    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.tokenizer import Vocab

    return Generator(params, _cfg(inp, f"eng/{case}/cfg"),
                     Vocab(json.loads(str(inp["eng/vocab"]))),
                     eos_token="none", pad_token="t0", device=CPU, tp=tp)


def _engine_failures(rank: int, world: int, inp, spec, res: dict,
                     tmp: str) -> None:
    """Faults on a model group of ``world``, each on a group of its own
    whose collectives time out after ``spec["fail_timeout"]`` s. The
    leader submits a request, then the poisoned prompt once the first
    chunk ran. The faults: "leader", the leader's harvest raises (its own
    work); "plan", every rank's admission of the poisoned prompt raises
    (a fault the plan brings); "follower", rank 1's admission of it raises
    (a fault of one rank inside the shared work), and rank 1's process
    exits, as ``serve_follower``'s caller is to. Into ``res``, per fault:
    what the leader's requests (in order) and the follower's loop raised,
    whether the leader's worker ended, and each rank's seconds. Rank 1
    writes its results and exits at "follower", so that fault comes
    last."""
    import datetime
    import threading
    import time

    import torch.distributed as dist

    from eamg_tpu_torch.parallel.collectives import tensor_parallel
    from eamg_tpu_torch.parallel.mesh import make_mesh, shard_params
    from eamg_tpu_torch.serve.continuous import ContinuousBatcher

    cfg = _cfg(inp, "eng/mha/cfg")
    blocks = shard_params(_params(inp, "eng/mha/p"), make_mesh(1, world),
                          tp=True, cfg=cfg)
    poison, limit = tuple(spec["poison"]), spec["fail_timeout"]
    for fault in ("leader", "plan", "follower"):
        group = dist.new_group(list(range(world)),
                               timeout=datetime.timedelta(seconds=limit))
        gen = _engine_generator(inp, "mha", blocks,
                                tensor_parallel(cfg, group))
        eng = ContinuousBatcher(gen, slots=spec["slots"],
                                chunk=spec["chunk"], max_len=spec["max_len"],
                                top_k=spec["top_k"])
        if fault == "leader" and rank == 0:
            def harvest(*args):
                raise RuntimeError("poisoned harvest")

            eng._harvest = harvest
        if fault == "plan" or (fault == "follower" and rank == 1):
            def admit(a, medusa_row=False, admit_row=eng._admit_row):
                if tuple(a.prompt_ids) == poison:
                    raise RuntimeError("poisoned admission")
                return admit_row(a, medusa_row)

            eng._admit_row = admit
        t0 = time.monotonic()
        pre = f"fail/{fault}"
        if eng.leader:
            errors = {}

            def hit(i, ids):
                errors[i] = str(_raised(
                    lambda: eng.submit(ids, seed=1, timeout=2 * limit)))

            threads = [threading.Thread(target=hit, args=(i, ids),
                                        daemon=True)
                       for i, ids in enumerate((spec["requests"][0][0],
                                                poison))]
            threads[0].start()
            while eng.stats["chunks"] < 1 and time.monotonic() - t0 < limit:
                time.sleep(0.001)
            threads[1].start()
            for t in threads:
                t.join(timeout=2 * limit)
            eng._thread.join(timeout=limit)
            res[f"{pre}/errors"] = np.asarray(
                [errors.get(i, "no answer") for i in range(2)])
            res[f"{pre}/closed"] = np.asarray(not eng._thread.is_alive())
            res[f"{pre}/seconds"] = np.asarray(time.monotonic() - t0)
        else:
            res[f"{pre}/follower"] = _raised(eng.serve_follower)
            res[f"{pre}/seconds"] = np.asarray(time.monotonic() - t0)
            if fault == "follower":
                _keep(res, tmp, "engine_world", world, rank)
                os._exit(0)


def engine_world(rank: int, world: int, inp, tmp: str) -> dict:
    from eamg_tpu_torch.decode.grammar import grammar_a
    from eamg_tpu_torch.parallel.collectives import tensor_parallel
    from eamg_tpu_torch.parallel.mesh import make_mesh, shard_params
    from eamg_tpu_torch.serve.continuous import ContinuousBatcher
    from eamg_tpu_torch.tokenizer import Vocab

    spec = json.loads(str(inp["eng/spec"]))
    gram = grammar_a(Vocab(json.loads(str(inp["eng/names"]))))
    res = {}
    for case in spec["cases"]:
        cfg = _cfg(inp, f"eng/{case}/cfg")
        mesh = make_mesh(1, world)
        tp = tensor_parallel(cfg, mesh.get_group("model"))
        blocks = shard_params(_params(inp, f"eng/{case}/p"), mesh, tp=True,
                              cfg=cfg)
        gen = _engine_generator(inp, case, blocks, tp)
        _engine_results(gen, spec, case, gram, res)
        res[f"{case}/ragged"] = _ragged_rows(gen, spec, tp)
        res[f"{case}/kv_heads"] = tp.kv_heads
        res[f"{case}/n_head"] = tp.n_head
        if world == 2 and case == "mha":
            heads = {"blocks": [{"w": torch.zeros(cfg.d_model, cfg.d_model),
                                 "b": torch.zeros(cfg.d_model)}]}
            res["medusa_error"] = _raised(lambda: ContinuousBatcher(
                gen, slots=2, chunk=4, max_len=16, medusa_heads=heads))
            from eamg_tpu_torch.serve.batcher import RequestBatcher

            ids = spec["requests"][0][0]
            for route, fn in (
                    ("window", lambda: RequestBatcher(gen)),
                    ("uncached", lambda: gen.generate_ids(
                        ids, max_len=16, use_cache=False)),
                    ("beams", lambda: gen.generate_ids_beam(ids, 16)),
                    ("lookup", lambda: gen.generate_ids_lookup(ids, 16)),
                    ("medusa", lambda: gen.generate_ids_medusa(heads, ids,
                                                               16))):
                res[f"refused/{route}"] = _raised(fn)
    if world == 2:
        _engine_failures(rank, world, inp, spec, res, tmp)
    return res


def task_sharded_engine(inp, out) -> None:
    """tests/test_torch_sharded_engine.py."""
    from eamg_tpu_torch.decode.grammar import grammar_a
    from eamg_tpu_torch.tokenizer import Vocab

    spec = json.loads(str(inp["eng/spec"]))
    gram = grammar_a(Vocab(json.loads(str(inp["eng/names"]))))
    for case in spec["cases"]:
        res = {}
        gen = _engine_generator(inp, case, _params(inp, f"eng/{case}/p"))
        _engine_results(gen, spec, case, gram, res)
        _merge(out, "one", {k: v for k, v in res.items()
                            if "/state/" not in k and "joined" not in k})
    tmp = tempfile.mkdtemp()
    with _one_rank_world(tmp, "eng1"):
        _merge(out, "w1/r0", engine_world(0, 1, inp, tmp))
    for world in (2, 4):
        for r, res in enumerate(spawn("engine_world", world, inp, tmp)):
            _merge(out, f"w{world}/r{r}", res)


PARALLEL_TASKS = {"mesh": task_mesh, "pipeline": task_pipeline,
                  "ring": task_ring, "ep": task_ep,
                  "sharded_decode": task_sharded_decode,
                  "sharded_engine": task_sharded_engine}
