"""The decode cluster kernel (K3, flash_decode, flash_decode_vmem), K1 and
K4 on one CUDA card, across their launch choices.

    python3 chip_sweep.py                    # scalar_t, sp, attention
    python3 chip_sweep.py sp topk            # some parts
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
 - parent=DIR: K4 (its threshold, and the sampler's top-k) and the
   stream-reduce probe (at the engine's cache and at 67 MB, with the L2
   dirty and clean) as the kernels of a parent tree unpacked in DIR (its
   eamg_tpu_torch/csrc, built here) and as this tree's, in turns in one
   loop (chip_sweep.py::parent_vs_change); then the parent tree and this
   one each serve the solo WAV of seed 7 and the engine's seed-21 request
   alone and in a burst, in processes of their own: the bytes must be
   equal (chip_sweep.py::same_seed_bytes; DIR holds the parent's package
   and chip_smoke.py, and its eamg_tpu/ the checkpoints).
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

PARTS = ("scalar_t", "sp", "attention", "topk", "parent")
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
    kernel_parts = {"topk", "parent"}
    _build.build_all(["topk", "stream_reduce"] if set(parts) <= kernel_parts
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
            for name in cs.SCALAR_T_KERNELS:
                for C in SIZES:
                    fn = (lambda name=name, C=C: da._scalar_t(name, q, k, v,
                                                              t, C=C))
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
                             [P, P, P, P, I, I, I, I, _build.F, I, I, I, P])
        o = torch.empty_like(q)
        for C in (2, 16):
            def run(C=C):
                _build.check(lib.eamg_flash_decode_scalar_t(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    64, 511, Dh, 300, 1.0 / math.sqrt(Dh), 1, C, 1,
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
    if "parent" in parts:
        parent_vs_change(torch, cs, _build, parent[0])
        same_seed_bytes(parent[0])
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
    """K4 and the stream-reduce probe as a parent tree's kernels
    (csrc/topk.cu and csrc/stream_reduce.cu under ``parent``, built here
    with the same flags; their entry points those of the tree before K4's
    digit select: eamg_kth_value without a thread count, a stream reduce
    of two launches over a partials buffer of ceil(lines / 16) slabs) and
    as this tree's, cold and warm, in turns in one loop: K4's threshold at
    f32 [1, 8892] and [8, 8892], k 50, and the sampler's top-k (the parent's
    threshold and three ops against the fused mask) beside torch.topk; the
    probe at bf16 [8, 511, 256] and [64, 511, 1024], rows 4, with the L2
    left dirty and clean, beside torch's sum of the whole array."""
    import subprocess

    from eamg_tpu_torch.ops import decode_fold as df, topk

    out = _build.BUILD_ROOT.parent / "sweep_parent"
    out.mkdir(parents=True, exist_ok=True)
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(out / f"lib{n}.so"),
                               os.path.join(parent, "eamg_tpu_torch", "csrc",
                                            f"{n}.cu")])
             for n in ("topk", "stream_reduce")]
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed on the parent's sources")
    P, I = ctypes.c_void_p, ctypes.c_int
    old_tk = ctypes.CDLL(str(out / "libtopk.so"))
    old_sr = ctypes.CDLL(str(out / "libstream_reduce.so"))
    for fn, args in ((old_tk.eamg_kth_value, [P, P, I, I, I, P]),
                     (old_sr.eamg_stream_reduce, [P, P, P, I, I, I, I, P])):
        fn.argtypes, fn.restype = args, ctypes.c_int

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def report(tag, ms, lib="library"):
        print(f"[parent] {tag}: parent {ms['parent']:.4f} ms, change "
              f"{ms['change']:.4f} ms ({ms['change'] / ms['parent']:.3f} of "
              f"the parent's), {lib} {ms['library']:.4f} ms", flush=True)

    g = torch.Generator().manual_seed(7)
    for B in (1, 8):
        x = (torch.randn(B, 8892, generator=g) * 3).cuda()
        thr = torch.empty((B, 1), dtype=torch.float32, device="cuda")

        def old_kth(x=x, thr=thr, B=B):
            _build.check(old_tk.eamg_kth_value(
                x.data_ptr(), thr.data_ptr(), B, x.shape[1], 50, stream()),
                "parent K4")
            return thr

        if not torch.equal(old_kth(), topk.kth_value(x, 50)):
            raise AssertionError("K4: the parent's threshold differs")
        fns = {"parent": old_kth,
               "change": lambda x=x: topk.kth_value(x, 50),
               "library": lambda x=x: torch.topk(x, 50).values[..., -1:]}
        tag = f"K4 threshold f32 [{B}, 8892] k 50"
        report(tag + " cold", cs.time_cold_ms(torch, fns), "topk")
        report(tag + " warm", {n: cs.time_ms(torch, f)
                               for n, f in fns.items()}, "topk")
        fns = {"parent": lambda x=x, f=old_kth: topk._masked(x, f(), -1e10),
               "change": lambda x=x: topk.top_k_mask(x, 50),
               "library": lambda x=x: topk._masked(
                   x, torch.topk(x, 50).values[..., -1:], -1e10)}
        if not torch.equal(fns["parent"](), fns["change"]()):
            raise AssertionError("K4: the parent's top-k mask differs")
        tag = f"sampler top-k f32 [{B}, 8892] k 50 (parent: K4 + 3 ops)"
        report(tag + " cold", cs.time_cold_ms(torch, fns), "topk + 3 ops")
        report(tag + " warm", {n: cs.time_ms(torch, f)
                               for n, f in fns.items()}, "topk + 3 ops")
    for shape in ((8, 511, 256), (64, 511, 1024)):
        kv = torch.randn(*shape, generator=g).to(torch.bfloat16).cuda()
        groups, lines, W = shape[0] // 4, 4 * shape[1], shape[2]
        part = torch.empty(groups * -(-lines // 16) * W, dtype=torch.float32,
                           device="cuda")
        o = torch.empty((1, W), dtype=kv.dtype, device="cuda")

        def old_sum(kv=kv, part=part, o=o, groups=groups, lines=lines, W=W):
            _build.check(old_sr.eamg_stream_reduce(
                kv.data_ptr(), o.data_ptr(), part.data_ptr(), groups, lines,
                W, 1, stream()), "parent stream_reduce")
            return o

        diff = (old_sum().float() - df.stream_reduce(kv, 4).float()).abs()
        print(f"[parent] stream_reduce {list(shape)} parent against change, "
              f"max|diff| {diff.max().item():.3e} (sums in other orders)",
              flush=True)
        fns = {"parent": old_sum,
               "change": lambda kv=kv: df.stream_reduce(kv, 4),
               "library": lambda kv=kv: kv.sum(dtype=torch.float32)}
        nb = kv.numel() * kv.element_size()
        for how, clean in (("cold", False), ("cold, clean L2", True)):
            ms = cs.time_cold_ms(torch, fns, read_flush=clean)
            report(f"stream_reduce bf16 {list(shape)} rows 4 {how} (GB/s: "
                   + ", ".join(f"{n} {nb / v / 1e6:.1f}"
                               for n, v in ms.items()) + ")", ms,
                   "sum of the whole array")
        report(f"stream_reduce bf16 {list(shape)} rows 4 warm",
               {n: cs.time_ms(torch, f) for n, f in fns.items()},
               "sum of the whole array")


# Run in a tree's root (its package, its chip_smoke.py): the same-seed
# replies whose bytes a kernel change must not move, as sha256 digests
SAME_SEED_CHILD = r"""
import hashlib, json, os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from eamg_tpu_torch import cli
from eamg_tpu_torch.ops import _build
from eamg_tpu_torch.serve import shutdown_gracefully

_build.build_all(_build.SOURCES)


def served(args, work):
    pipe = cli.pipeline_from_args(cli.parse_args(args))
    if "--coalesce" in args:
        pipe.warmup()
    server, thread, port = cs._serving(pipe)
    try:
        return work(port)
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)


def digest(b):
    return hashlib.sha256(b).hexdigest()


def engine(port):
    lone = cs._post(port, cs.LONE, "")[1]
    again = cs._burst(port, "same seed", lone_again=True)[2]
    return digest(lone), digest(again)


out = {"solo wav seed 7": served(["serve"], lambda port: digest(cs._post(
    port, {"prompt": "I finally got the job, I am so happy!", "seed": "7"},
    "")[1]))}
out["engine lone seed 21"], out["engine seed 21 in the burst"] = served(
    ["serve", "--coalesce", "--slots", "8"], engine)
print("SAME_SEED " + json.dumps(out), flush=True)
"""


def same_seed_bytes(parent: str) -> None:
    """The solo WAV of seed 7 and the engine's seed-21 request, alone and
    inside the burst of ten, served by the parent tree and by this one, each
    in a process of its own on this card: their bytes must be equal."""
    import json
    import subprocess

    here = os.path.dirname(os.path.abspath(__file__))
    got = {}
    for tag, root in (("parent", os.path.abspath(parent)), ("change", here)):
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run([sys.executable, "-c", SAME_SEED_CHILD],
                              cwd=root, env=env, capture_output=True,
                              text=True, timeout=900)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("SAME_SEED ")]
        if proc.returncode != 0 or not line:
            raise RuntimeError(f"same-seed run of the {tag} tree failed:\n"
                               f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        got[tag] = json.loads(line[0].split(" ", 1)[1])
        print(f"[same seed] {tag}: {got[tag]}", flush=True)
    if got["parent"] != got["change"]:
        raise AssertionError("same-seed bytes differ from the parent's")
    print("[same seed] the parent's and this tree's bytes are equal",
          flush=True)


if __name__ == "__main__":
    sys.exit(main())
