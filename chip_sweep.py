"""The decode cluster kernel (K3, flash_decode, flash_decode_vmem), K1 and
K4 on one CUDA card, across their launch choices; the decode graphs' block
size; a parent tree against this one.

    python3 chip_sweep.py                    # scalar_t, sp, attention
    python3 chip_sweep.py sp topk            # some parts
    python3 chip_sweep.py blocks             # the solo decode's block size
    python3 chip_sweep.py parent=DIR         # against a parent tree in DIR

Parts, each timed cold (chip_smoke.py's graph replays with the L2 flushed
between them), in bf16, beside one library call:
 - scalar_t: flash_decode's and flash_decode_vmem's kernel with C = 1, 2,
   4, 8 and 16 blocks a (row, head) against SDPA on the keys 0..t, at Dh
   64: B 8, H 8 at M 511 (t 300 and 510), 2048 and 4096 (t M - 1), and B
   1, H 8 at M 16384 and 60000 (t M - 1); then the bench shape once more
   with a flush that reads the 384 MB instead of zeroing them, and the
   phases at C 2 and C 16 from the stamped build (chip_smoke.py::
   kernel_phases has the layout), whose entry skew shows how far apart
   the card starts the blocks;
 - sp: K3 (t [B] on the card) with C = 1, 2, 4, 8 and 16 blocks a (row,
   KV head) against SDPA on the keys 0..t, at Dh 64: the solo shape (B 1,
   H 8, Hkv 2, M 511, t 300 and 510), the bench shape (B 8, MHA H 8, M
   511, t 300 and 510), and at M 2048 and 16384 (t M - 1, B 1, GQA-2);
   then its phases at the solo shape with each C;
 - attention: K1 with 1, 2, 4 and 8 warps a block against SDPA: the solo
   prefill (B 1, H 8, Hkv 2, T 16, causal), the batch's (B 8, MHA, T 16,
   valid_len 3), and T 64 and 511 (B 1, GQA-2, causal), each also warm;
 - topk: K4's fused mask (f32, k 50) at the path shapes, B3's vocabulary,
   V 8579 and V 60000, beside torch.topk and the three ops;
 - blocks: the solo path's decode (demo_ckpt_a) with graphs of 16, 32
   and 64 steps, ten requests each, sizes in turns (block_sweep);
 - parent=DIR: rows 5 and 6 as the kernel of a parent tree unpacked in
   DIR (its csrc/decode_attention.cu, built here; t by value) and as this
   tree's (t read on the card), bit-equal, cold and warm in turns in one
   loop (parent_vs_change); then each path served by the parent tree and
   by this one in processes of their own, parent, change, change, parent:
   solo decode tokens/s, the engine's burst (aggregate tokens/s, p50 and
   p95 join), batch tokens/s per attn_impl, and a traced request, burst
   and batch generation each (rate, device idle share, device kernels and
   host launch calls a token); the same-seed bytes (solo WAV seed 7, the
   engine's seed 21 alone and in the burst) must be equal
   (paths_parent_vs_change; DIR holds the parent's package and
   chip_smoke.py, and its eamg_tpu/ the checkpoints).
The size each wrapper picks is marked with *. A cluster size whose blocks
would need more shared memory than the card allows (C 1 at M 60000) is
reported as refused. Prints the card line and one line per measurement;
exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import sys

PARTS = ("scalar_t", "sp", "attention", "topk", "blocks", "parent")
SIZES = (1, 2, 4, 8, 16)


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    args = list(argv if argv is not None else sys.argv[1:])
    parent = [a.split("=", 1)[1] for a in args if a.startswith("parent=")]
    parts = [a.split("=", 1)[0] for a in args] or list(PARTS[:3])
    if any(p not in PARTS for p in parts) or ("parent" in parts) != bool(
            parent):
        print(f"chip_sweep: parts are {PARTS} (parent=DIR)", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("chip_sweep: no CUDA device; nothing to run", flush=True)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from eamg_tpu_torch.ops import _build, attention as at, \
        decode_attention as da

    print(cs.card_line(), flush=True)
    _build.build_all(_build.SOURCES if {"blocks", "parent"} & set(parts)
                     else ["topk"] if parts == ["topk"]
                     else ["decode_attention", "decode_attention_timed",
                           "attention", "decode_fold"])
    g = torch.Generator().manual_seed(511)
    dt, Dh = torch.bfloat16, 64
    khz = torch.cuda.get_device_properties(0).clock_rate
    P, I = ctypes.c_void_p, ctypes.c_int

    def draw(*shape):
        return torch.randn(*shape, generator=g).to(dt).cuda()

    def runnable(fn):
        try:
            fn()
        except RuntimeError as exc:   # a block past 227 KB
            if "shared memory" not in str(exc):
                raise
            return False
        return True

    def sdpa(q, k, v, t):
        return lambda: F.scaled_dot_product_attention(
            q, k[:, :, :t + 1], v[:, :, :t + 1], enable_gqa=True)

    def line(tag, picked, ms, keys, lib="sdpa"):
        print(f"[sweep] {tag}: " + ", ".join(
            f"{label} {k}{'*' if k == picked else ''} "
            + (f"{ms[key]:.4f}" if key in ms else "refused")
            for label, k, key in keys) + f" ms; {lib} {ms['sdpa']:.4f} ms",
            flush=True)

    if "scalar_t" in parts:
        def timed(q, k, v, t, flush_reads=False):
            fns = {"sdpa": sdpa(q, k, v, t)}
            td = torch.full((1,), t, dtype=torch.int32, device="cuda")
            for name in cs.SCALAR_T_KERNELS:
                for C in SIZES:
                    fn = (lambda name=name, C=C: da._scalar_t(name, q, k, v,
                                                              td, C=C))
                    if runnable(fn):
                        fns[(name, C)] = fn
            return cs.time_cold_ms(torch, fns, iters=30,
                                   read_flush=flush_reads)

        def report(tag, M, ms):
            picked = da.cluster_size(
                M, 1, lambda: da.cluster_occupancy(M, Dh, 1, 256, dt)[1])
            for name in cs.SCALAR_T_KERNELS:
                line(f"{tag} {name}", picked, ms,
                     [("C", C, (name, C)) for C in SIZES])

        for B, M, ts in ((8, 511, (300, 510)), (8, 2048, (2047,)),
                         (8, 4096, (4095,)), (1, 16384, (16383,)),
                         (1, 60000, (59999,))):
            q, k, v = draw(B, 8, 1, Dh), draw(B, 8, M, Dh), draw(B, 8, M, Dh)
            for t in ts:
                report(f"B {B} H 8 M {M} t {t}", M, timed(q, k, v, t))
            if M == 511:
                report("B 8 H 8 M 511 t 300, a flush that reads", M,
                       timed(q, k, v, 300, flush_reads=True))
                bench = (q, k, v)
            else:
                del q, k, v

        # phases at C 2 and C 16, bench shape, t 300, flash_decode's
        # rounding
        q, k, v = bench
        lib = cs._bind_timed("decode_attention_timed",
                             "eamg_flash_decode_scalar_t",
                             [P, P, P, P, I, I, I, P, _build.F, I, I, I, P])
        o = torch.empty_like(q)
        t300 = torch.full((1,), 300, dtype=torch.int32, device="cuda")
        for C in (2, 16):
            def run(C=C):
                _build.check(lib.eamg_flash_decode_scalar_t(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    64, 511, Dh, t300.data_ptr(), 1.0 / math.sqrt(Dh), 1, C,
                    1,
                    torch.cuda.current_stream().cuda_stream),
                    "stamped kernel")
            r = cs._stamped_runs(torch, lib, run, 64 * C, cs.DECODE_STAMPS,
                                 khz)
            cs._log_phases(f"flash_decode C {C}, B 8 H 8 M 511 t 300", r,
                           khz)
        del bench, q, k, v

    if "sp" in parts:
        for B, H, Hkv, M, ts in ((1, 8, 2, 511, (300, 510)),
                                 (8, 8, 8, 511, (300, 510)),
                                 (1, 8, 2, 2048, (2047,)),
                                 (1, 8, 2, 16384, (16383,))):
            q, k, v = draw(B, H, 1, Dh), draw(B, Hkv, M, Dh), \
                draw(B, Hkv, M, Dh)
            by_head, picked = da.sp_plan(M, Dh, H // Hkv, 2, lambda: da
                                         .cluster_occupancy(M, Dh, H // Hkv,
                                                            128, dt)[1])
            for t in ts:
                tt = torch.full((B,), t, dtype=torch.int32, device="cuda")
                fns = {"sdpa": sdpa(q, k, v, t)}
                if by_head:
                    fns["heads"] = lambda tt=tt: da.flash_decode_sp(q, k, v,
                                                                   tt)
                for C in SIZES:
                    fn = (lambda C=C, tt=tt: da._flash_decode_sp(q, k, v,
                                                                 tt, C=C))
                    if runnable(fn):
                        fns[C] = fn
                line(f"flash_decode_sp B {B} H {H} Hkv {Hkv} M {M} t {t}",
                     "heads" if by_head else picked,
                     cs.time_cold_ms(torch, fns, iters=30),
                     [("by head", "heads", "heads")] * by_head
                     + [("C", C, C) for C in SIZES])
            if (B, M) == (1, 511):
                solo = (q, k, v)
            else:
                del q, k, v
        # K3's phases at the solo shape, t 300 on the card, with each C
        q, k, v = solo
        lib = cs._bind_timed("decode_attention_timed", "eamg_flash_decode_sp",
                             [P, P, P, P, P, I, I, I, I, I, _build.F, I, I,
                              I, P])
        o = torch.empty_like(q)
        tt = torch.full((1,), 300, dtype=torch.int32, device="cuda")
        for by_head, C in ((1, 4), *((0, C) for C in SIZES)):
            def run(C=C, by_head=by_head):
                _build.check(lib.eamg_flash_decode_sp(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), tt.data_ptr(),
                    o.data_ptr(), 1, 8, 2, 511, Dh, 1.0 / math.sqrt(Dh),
                    by_head, C, 1, torch.cuda.current_stream().cuda_stream),
                    "stamped K3")
            r = cs._stamped_runs(torch, lib, run, 2 * C, cs.HEADS_STAMPS
                                 if by_head else cs.DECODE_STAMPS, khz)
            cs._log_phases(f"flash_decode_sp {'by head' if by_head else ''} "
                           f"C {C}, B 1 H 8 Hkv 2 M 511 t 300", r, khz)
        del solo, q, k, v

    if "attention" in parts:
        for B, H, Hkv, T, vl in ((1, 8, 2, 16, 16), (8, 8, 8, 16, 3),
                                 (1, 8, 2, 64, 64), (1, 8, 2, 511, 511)):
            q, k, v = draw(B, H, T, Dh), draw(B, Hkv, T, Dh), \
                draw(B, Hkv, T, Dh)
            lens = torch.full((B,), vl, dtype=torch.int32, device="cuda")
            keep = (torch.arange(T, device="cuda")[None, :]
                    <= torch.arange(T, device="cuda")[:, None]) \
                & (torch.arange(T, device="cuda")[None, :] < vl)
            mask = {"attn_mask": keep} if vl < T else {"is_causal": True}
            fns = {"sdpa": lambda mask=mask: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True, **mask)}
            for W in (1, 2, 4, 8):
                fns[W] = (lambda W=W: at._flash_attention(q, k, v, lens,
                                                          True, W))
            picked = at.WARPS
            tag = f"flash_attention B {B} H {H} Hkv {Hkv} T {T} valid {vl}"
            keys = [("W", W, W) for W in (1, 2, 4, 8)]
            line(tag + " cold", picked, cs.time_cold_ms(torch, fns,
                                                        iters=30), keys)
            line(tag + " warm", picked,
                 {n: cs.time_ms(torch, fn) for n, fn in fns.items()}, keys)
            del q, k, v
    if "topk" in parts:
        topk_sweep(torch, cs)
    if "blocks" in parts:
        block_sweep(torch, cs)
    if "parent" in parts:
        parent_vs_change(torch, cs, _build, parent[0])
        paths_parent_vs_change(parent[0])
    return 0


TOPK_SHAPES = ((1, 8892), (8, 8892), (8, 8324), (8, 8579), (1, 60000))


def topk_sweep(torch, cs) -> None:
    """K4's fused mask (f32, k 50) at TOPK_SHAPES (the solo and engine
    steps, B3's vocabulary, a V no multiple of 4 that loads element by
    element, and a row past the registers), cold and warm in one loop,
    beside torch.topk and the three ops."""
    from eamg_tpu_torch.ops import topk

    g = torch.Generator().manual_seed(4)
    for B, V in TOPK_SHAPES:
        x = (torch.randn(B, V, generator=g) * 3).cuda()
        if not torch.equal(topk.top_k_mask(x, 50).view(torch.int32),
                           topk.top_k_mask_plain(x, 50).view(torch.int32)):
            raise AssertionError(f"K4 [{B}, {V}]: not bit-equal")
        fns = {"kernel": lambda x=x: topk.top_k_mask(x, 50),
               "topk and the three ops": lambda x=x: topk._masked(
                   x, torch.topk(x, 50).values[..., -1:], -1e10)}
        cold = cs.time_cold_ms(torch, fns, iters=40)
        warm = {n: cs.time_ms(torch, fn) for n, fn in fns.items()}
        print(f"[topk] fused mask f32 [{B}, {V}] k 50, bit-equal; cold / "
              "warm ms: " + ", ".join(f"{n} {cold[n]:.4f} / {warm[n]:.4f}"
                                      for n in fns), flush=True)


def parent_vs_change(torch, cs, _build, parent: str) -> None:
    """Rows 5 and 6 (flash_decode and flash_decode_vmem: the scalar-t
    cluster kernel) as a parent tree's kernel (csrc/decode_attention.cu
    under ``parent``, built here with the same flags; its entry takes t by
    value) and as this tree's (t read on the card through a pointer),
    cold and warm, in turns in one loop, at the batched decode's shape
    (bf16, B 8, MHA H 8, M 511, Dh 64) at t 300 and 510, with the cluster
    size the wrapper picks, beside SDPA on the keys 0..t; their outputs
    must be bit-equal."""
    import subprocess

    import torch.nn.functional as F

    from eamg_tpu_torch.ops import decode_attention as da

    out = _build.BUILD_ROOT.parent / "sweep_parent"
    out.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(out / "libdecode_attention.so"),
                           os.path.join(parent, "eamg_tpu_torch", "csrc",
                                        "decode_attention.cu")])
    if proc.returncode:
        raise RuntimeError("nvcc failed on the parent's sources")
    P, I = ctypes.c_void_p, ctypes.c_int
    old = ctypes.CDLL(str(out / "libdecode_attention.so"))
    fn = old.eamg_flash_decode_scalar_t
    fn.argtypes = [P, P, P, P, I, I, I, I, ctypes.c_float, I, I, I, P]
    fn.restype = ctypes.c_int
    g = torch.Generator().manual_seed(300)
    B, H, M, Dh = 8, 8, 511, 64
    q, k, v = (torch.randn(B, H, m, Dh, generator=g).to(torch.bfloat16)
               .cuda() for m in (1, M, M))
    C = da.cluster_size(M, 1, lambda: 0)
    for t in (300, 510):
        td = torch.full((1,), t, dtype=torch.int32, device="cuda")
        for name in cs.SCALAR_T_KERNELS:
            o = torch.empty_like(q)
            blocked = int(da.BLOCK_K[name] > 0)

            def parent_fn(o=o, blocked=blocked, t=t):
                _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), B * H, M, Dh, t,
                                1.0 / math.sqrt(Dh), blocked, C, 1,
                                torch.cuda.current_stream().cuda_stream),
                             "parent scalar-t kernel")
                return o

            fns = {"parent": parent_fn,
                   "change": lambda name=name, td=td: getattr(da, name)(
                       q, k, v, td),
                   "library": lambda t=t: F.scaled_dot_product_attention(
                       q, k[:, :, :t + 1], v[:, :, :t + 1])}
            if not torch.equal(fns["parent"](), fns["change"]()):
                raise AssertionError(f"{name} t {t}: the change's output "
                                     "differs from the parent's")
            cold = cs.time_cold_ms(torch, fns)
            warm = {n: cs.time_ms(torch, f) for n, f in fns.items()}
            print(f"[parent] {name} bf16 B {B} H {H} M {M} t {t} C {C}, "
                  f"bit-equal; cold: parent {cold['parent']:.4f} ms, change "
                  f"{cold['change']:.4f} ms (t read on the card), SDPA "
                  f"{cold['library']:.4f}; warm: parent "
                  f"{warm['parent']:.4f}, change {warm['change']:.4f}, SDPA "
                  f"{warm['library']:.4f}", flush=True)


# Run in a tree's root (its package, its chip_smoke.py): each path's rate,
# launches and idle share, and the same-seed replies as sha256 digests
PATHS_CHILD = r"""
import collections, hashlib, json, os, sys, time
sys.path.insert(0, os.getcwd())
import torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from eamg_tpu_torch import bench, cli
from eamg_tpu_torch.ops import _build
from eamg_tpu_torch.serve import shutdown_gracefully

_build.build_all(_build.SOURCES)
APIS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
        "cudaGraphLaunch")
TEXT = "I finally got the job, I am so happy!"


def traced(work):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n = work()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000
    busy = kernels = 0
    by_name = collections.Counter()
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type.name == "CUDA":
            busy += us / 1000
            kernels += e.count
            by_name[e.key[:70]] += e.count
    host = collections.Counter(e.name for e in prof.events()
                               if e.device_type.name == "CPU"
                               and e.name.startswith(APIS))
    return {"tokens": n, "wall_ms": wall, "tokens_per_s": n / wall * 1000,
            "device_busy_ms": busy, "idle_share": 1 - busy / wall,
            "device_kernels_per_token": kernels / n,
            "host_launches_per_token": sum(host.values()) / n,
            "host_launches_by_api": dict(host),
            "kernels_by_name": dict(by_name.most_common(30))}


def served(args, work):
    pipe = cli.pipeline_from_args(cli.parse_args(args))
    pipe.warmup()
    server, thread, port = cs._serving(pipe)
    try:
        return work(pipe, port)
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)


def digest(b):
    return hashlib.sha256(b).hexdigest()


def decode_rate(reply):
    t = json.loads(reply[2].get("X-EAMG-Timings", "{}"))
    return int(reply[2].get("X-EAMG-Tokens", "0")) / t["decode"] * 1000


def solo(pipe, port):
    fields = {"prompt": TEXT, "seed": "7"}
    replies = [cs._post(port, fields) for _ in range(3)]
    pipe.generate(TEXT, seed=7)
    return {"wav seed 7": digest(replies[0][1]),
            "decode_tokens_per_s": [decode_rate(r) for r in replies],
            "trace": traced(lambda: len(pipe.generate(TEXT, seed=7).tokens))}


def engine(pipe, port):
    lone = cs._post(port, cs.LONE, "")
    joins = pipe.batcher.stats["join_delay_ms"]
    n0 = len(joins)
    tokens, secs, again = cs._burst(port, "paths", lone_again=True)
    burst_joins = sorted(list(joins)[n0:])
    p = lambda q: burst_joins[min(len(burst_joins) - 1,
                                  int(q * len(burst_joins)))]
    trace = traced(lambda: cs._burst(port, "paths traced", False)[0])
    return {"lone seed 21": digest(lone[1]), "seed 21 in the burst":
            digest(again), "burst_tokens_per_s": tokens / secs,
            "burst_join_p50_ms": p(0.5), "burst_join_p95_ms": p(0.95),
            "burst_joins": len(burst_joins), "trace": trace}


def batch():
    cfg = bench.large2_config()
    params = bench.make_params(cfg, 0, "cuda")
    prompt = bench.bench_prompt("cuda")
    n_tok = (cfg.n_pos - len(bench.PROMPT)) * prompt.shape[0]
    out = {}
    for impl in ("sp", "dma", "vmem", "fold", "fold2", "fold3", "fold_sp",
                 "fold3_sp"):
        bench.run_once(params, cfg, prompt, 0, cfg.n_pos, impl)
        best = float("inf")
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bench.run_once(params, cfg, prompt, 1 + i, cfg.n_pos, impl)
            best = min(best, time.perf_counter() - t0)
        out[impl] = n_tok / best
    trace = traced(lambda: (bench.run_once(params, cfg, prompt, 3,
                                           cfg.n_pos, "sp"), n_tok)[1])
    return {"tokens_per_s": out, "trace": trace}


out = {"solo": served(["serve"], solo),
       "coalesce": served(["serve", "--coalesce", "--slots", "8"], engine),
       "batch": batch()}
print("PATHS " + json.dumps(out), flush=True)
"""


def paths_parent_vs_change(parent: str) -> None:
    """The three paths served by the parent tree and by this one, each in
    a process of its own, in the order parent, change, change, parent
    (host speed drifts within a call): the solo decode rate of the WAV of
    seed 7, the burst of ten on the engine (aggregate tokens/s, p50 and
    p95 join over the burst's admissions), batch tokens/s per attn_impl
    (best of two after a warm-up), and for one traced request, burst and
    batch generation each: the rate, device idle share, device kernels a
    token and host launch calls a token. The same-seed bytes (solo seed 7,
    the engine's seed 21 alone and in the burst) must be equal."""
    import json
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for tag in ("parent", "change", "change", "parent"):
        root = os.path.abspath(parent) if tag == "parent" else here
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run([sys.executable, "-c", PATHS_CHILD],
                              cwd=root, env=env, capture_output=True,
                              text=True, timeout=1500)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("PATHS ")]
        if proc.returncode != 0 or not line:
            raise RuntimeError(f"paths run of the {tag} tree failed:\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append((tag, json.loads(line[0].split(" ", 1)[1])))
        print(f"[paths] {tag}: {line[0][6:]}", flush=True)
    digests = {(tag, path, k): v for tag, r in runs for path in r
               for k, v in r[path].items() if k.startswith(("wav", "lone",
                                                            "seed"))}
    for (tag, path, k), v in digests.items():
        if v != digests[("parent", path, k)]:
            raise AssertionError(f"same-seed bytes differ: {path} {k}")
    print("[same seed] the parent's and this tree's bytes are equal: "
          + json.dumps({f"{p} {k}": v for (t, p, k), v in digests.items()
                        if t == "parent"}), flush=True)


BLOCKS = (16, 32, 64)


def block_sweep(torch, cs) -> None:
    """The solo path's decode (demo_ckpt_a, the served key) with graphs of
    BLOCKS steps: for each, five same-seed requests after a warm-up, the
    decode ms (the stage timing, median) and the steps run past the EOS;
    the sizes in turns (16, 32, 64, 64, 32, 16)."""
    import statistics

    from eamg_tpu_torch import cli
    from eamg_tpu_torch.decode import graphs

    pipe = cli.pipeline_from_args(cli.parse_args(["serve"]))
    text = "I finally got the job, I am so happy!"
    ms = {b: [] for b in BLOCKS}
    tokens = {}
    for b in (*BLOCKS, *reversed(BLOCKS)):
        graphs.BLOCK = b
        pipe.generate(text, seed=7, render_audio=False)       # capture
        for seed in (7, 8, 9, 10, 11):
            r = pipe.generate(text, seed=seed, render_audio=False)
            ms[b].append(r.timings_ms["decode"])
            tokens[seed] = len(r.tokens)
    graphs.BLOCK = 32
    for b in BLOCKS:
        print(f"[blocks] solo decode, blocks of {b} steps: median "
              f"{statistics.median(ms[b]):.1f} ms over {len(ms[b])} "
              f"requests ({[round(v, 1) for v in ms[b]]}); tokens by seed "
              f"{tokens}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
