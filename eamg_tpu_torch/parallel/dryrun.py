"""A dry run of every parallel mode on the flagship geometry.

    python -m eamg_tpu_torch.parallel.dryrun --world N [--device cpu]

The port's counterpart of ``__graft_entry__.py::dryrun_multichip``: it
spawns N ranks (gloo on the CPU with ``--device cpu``, else one NCCL rank
a card; a world of 1 runs in the calling process) and drives, on the
``large2`` geometry (d512 h8 L6, the fixed 8,324-token Scheme-B2
vocabulary, T 31): a DP x TP trainer step (a model axis of 2 when N is
even and at least 4), a checkpoint written by rank 0 from the mesh and
resumed onto it (the resumed second step equal to the uninterrupted one),
greedy decoding on the resumed tensor-parallel params, an FSDP step (its
loss equal to the first step's), ring attention over all N ranks against
the plain attention, a GPipe step (DP x PP) and, at N >= 8, a dp x pp x tp
step against the plain loss, and expert parallelism against the dense MoE.
Rank 0 prints one line.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def _batch(seed: int, micro: int, V: int):
    r = np.random.default_rng(seed)
    return (r.integers(1, V, (2, micro, 31)).astype(np.int64),
            r.integers(1, V, (2, micro, 31)).astype(np.int64))


def _close(a: float, b: float, rtol: float, what: str) -> None:
    if not math.isclose(a, b, rel_tol=rtol, abs_tol=0.0):
        raise AssertionError(f"{what}: {a} != {b}")


def run_rank(rank: int, world: int, device: str, init_method: str,
             tmp: str) -> str | None:
    from ..decode.loop import generate_kv
    from ..models.gpt import init_params, preset
    from ..tokenizer import SchemeB2
    from ..train.trainer import TrainConfig, Trainer, loss_fn
    from ..utils import prng
    from ..utils.checkpoint import load_checkpoint, save_checkpoint
    from .mesh import make_mesh
    from .moe import (MoEConfig, init_moe_params, moe_mlp_dense, moe_mlp_ep,
                      shard_moe_params)
    from .multihost import init_distributed, is_main_process
    from .pipeline import PipelineTrainer, make_pp_mesh
    from .ring_attention import ring_attention

    dev = torch.device(device if device == "cpu" else f"cuda:{rank}")
    init_distributed(num_processes=world, process_id=rank, device=dev,
                     init_method=init_method)
    try:
        model_axis = 2 if world % 2 == 0 and world >= 4 else 1
        data_axis = world // model_axis
        mesh = make_mesh(data_axis, model_axis, device=dev)
        vocab = SchemeB2().vocab
        V = len(vocab)
        cfg = preset("large2", vocab_size=V)
        params = init_params(prng.PRNGKey(0), cfg, device=dev)
        tcfg = TrainConfig(accum_steps=2, micro_batch=2 * data_axis,
                           tp=model_axis > 1)
        trainer = Trainer(cfg, tcfg, params, device=dev, mesh=mesh)
        x1, y1 = _batch(1, tcfg.micro_batch, V)
        m1 = trainer.train_step(x1, y1)
        if not np.isfinite(m1["loss"]):
            raise AssertionError(m1)

        # the mesh's checkpoint, written by rank 0, resumed onto the mesh
        ck_dir = os.path.join(tmp, "ckpt")
        whole, opt = trainer.checkpoint_trees()
        if is_main_process():
            save_checkpoint(ck_dir, whole, vocab.tok2id, cfg, opt_state=opt,
                            step=trainer.step, tcfg=tcfg)
        dist.barrier()
        x2, y2 = _batch(2, tcfg.micro_batch, V)
        m2 = trainer.train_step(x2, y2)
        ck = load_checkpoint(ck_dir)
        if ck["step"] != 1 or ck["cfg"] != cfg:
            raise AssertionError((ck["step"], ck["cfg"]))
        resumed = Trainer(cfg, tcfg, ck["params"], device=dev, mesh=mesh)
        resumed.load_opt_state(ck["opt_state"])
        resumed.step = ck["step"]
        m2r = resumed.train_step(x2, y2)
        _close(m2["loss"], m2r["loss"], 1e-5, "resumed step 2")

        # greedy decoding on the resumed (tensor-parallel) params
        prompt = torch.zeros((8, 4), dtype=torch.int64, device=dev)
        prompt[:, :3] = torch.tensor([1, 5, 9])
        buf, pos = generate_kv(resumed.params, prompt, 3, prng.PRNGKey(0),
                               cfg, 16, greedy=True, eos_id=-1, pad_id=0,
                               refeed_last_prompt=False, tp=resumed.tp)
        if pos != 16:
            raise AssertionError(pos)
        decoded = buf[0, 3:6].tolist()
        del trainer, resumed

        # FSDP (with TP where the mesh has a model axis): step 1's loss
        fsdp = Trainer(cfg, TrainConfig(**{**tcfg.__dict__, "fsdp": True}),
                       params, device=dev, mesh=mesh)
        m_fsdp = fsdp.train_step(x1, y1)
        _close(m_fsdp["loss"], m1["loss"], 1e-5, "fsdp step 1")
        if data_axis > 1 and not any(
                lay.data_dim is not None for lay in fsdp.plan.layouts):
            raise AssertionError("FSDP left every param replicated")
        del fsdp

        # ring attention over every rank
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn((1, 2, 16 * world, 8), generator=g).to(dev)
                   for _ in range(3))
        ring = ring_attention(q, k, v, dist.group.WORLD, causal=True)
        T = 16 * world
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(8)
        s = s.masked_fill(~torch.ones((T, T), dtype=torch.bool,
                                      device=dev).tril(), -math.inf)
        ref = (torch.softmax(s, -1) @ v)[:, :, rank * 16:(rank + 1) * 16]
        ring_err = (ring - ref).abs().max().item()
        if ring_err > 5e-5:
            raise AssertionError(f"ring attention {ring_err}")

        # GPipe, DP x PP: the step's loss equals the plain loss
        stages = max(s for s in (1, 2, 3)
                     if cfg.n_layer % s == 0 and world % s == 0)
        pp = PipelineTrainer(cfg, tcfg, params,
                             make_pp_mesh(stages, data=world // stages,
                                          device=dev), n_micro=2, device=dev)
        xp, yp = _batch(3, tcfg.micro_batch, V)
        xt, yt = torch.from_numpy(xp[0]).to(dev), torch.from_numpy(yp[0]) \
            .to(dev)
        with torch.no_grad():
            ref_loss = float(loss_fn(params, xt, yt, cfg, tcfg.pad_id)[0])
        m_pp = pp.train_step(xt, yt)
        if abs(m_pp["loss"] - ref_loss) >= 1e-4:
            raise AssertionError((m_pp["loss"], ref_loss))
        del pp
        pp3 = ""
        if world >= 8 and world % 4 == 0:
            pp3_t = PipelineTrainer(cfg, tcfg, params, make_pp_mesh(
                2, data=world // 4, model=2, device=dev), n_micro=2,
                device=dev)
            m3 = pp3_t.train_step(xt, yt)
            if abs(m3["loss"] - ref_loss) >= 1e-4:
                raise AssertionError((m3["loss"], ref_loss))
            pp3 = (f"pp3axis[{world // 4}dp x 2pp x 2tp]_loss="
                   f"{m3['loss']:.4f}=={ref_loss:.4f} OK ")

        # expert parallelism against the dense MoE
        mcfg = MoEConfig(d_model=cfg.d_model, d_ff=cfg.d_model * 2,
                         n_experts=2 * world, top_k=2)
        mparams = init_moe_params(prng.PRNGKey(2), mcfg, device=dev)
        xe = torch.randn((2, 8 * world, cfg.d_model), generator=g).to(dev)
        N = xe.shape[0] * xe.shape[1]
        n_local = N // world
        mine = xe.reshape(N, cfg.d_model)[rank * n_local:(rank + 1)
                                          * n_local]
        ep = moe_mlp_ep(shard_moe_params(mparams, dist.group.WORLD), mine,
                        mcfg, dist.group.WORLD,
                        capacity=mcfg.top_k * n_local)
        dense = moe_mlp_dense(mparams, xe, mcfg, capacity=mcfg.top_k * N) \
            .reshape(N, cfg.d_model)[rank * n_local:(rank + 1) * n_local]
        ep_err = (ep - dense).abs().max().item()
        if ep_err > 1e-4:
            raise AssertionError(f"expert parallelism {ep_err}")

        if not is_main_process():
            return None
        return (f"dryrun({world}): mesh=({data_axis} data x {model_axis} "
                f"model) flagship d{cfg.d_model} L{cfg.n_layer} V{V} "
                f"loss1={m1['loss']:.4f} loss2={m2['loss']:.4f} "
                f"resumed_loss2={m2r['loss']:.4f} decode={decoded} "
                f"fsdp_loss={m_fsdp['loss']:.4f}==loss1 OK "
                f"ring_attention[seq={world}]=exact OK "
                f"pipeline[{world // stages}dp x {stages}pp]_loss="
                f"{m_pp['loss']:.4f}=={ref_loss:.4f} OK " + pp3 +
                f"moe_ep[{2 * world}experts/{world}dev]=dense-exact OK")
    finally:
        dist.destroy_process_group()


def _rank_main(rank: int, world: int, device: str, init_method: str,
               tmp: str) -> None:
    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    line = run_rank(rank, world, device, init_method, tmp)
    if line is not None:
        print(line, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks (default: a card a rank)")
    args = ap.parse_args(argv)
    device = args.device or "cuda"
    if device != "cpu":
        n = torch.cuda.device_count()
        if args.world > n:
            print(f"mesh {args.world}x1 > {n} devices", file=sys.stderr)
            return 2
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/rendezvous"
        if args.world == 1:
            _rank_main(0, 1, device, init, tmp)
        else:
            mp.start_processes(_rank_main, args=(args.world, device, init,
                                                 tmp),
                               nprocs=args.world, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
