"""The decode cluster kernel (K3, flash_decode, flash_decode_vmem) and K1 on
one CUDA card, across their launch choices.

    python3 chip_sweep.py                    # scalar_t, sp, attention
    python3 chip_sweep.py sp attention       # some parts
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
 - parent=DIR: K1, K3, rows 5 and 6 and rows 8 and 11 as the kernels of
   a parent tree unpacked in DIR (its eamg_tpu_torch/csrc, built here) and
   as this tree's, in turns in one loop (chip_sweep.py::parent_vs_change).
The size each wrapper picks is marked with *. A cluster size whose blocks
would need more shared memory than the card allows (C 1 at M 60000) is
reported as refused. Prints the card line and one line per measurement;
exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import math
import os
import sys

PARTS = ("scalar_t", "sp", "attention", "parent")
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
    _build.build_all(["decode_attention", "decode_attention_timed",
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
            if not flush_reads:
                return cs.time_cold_ms(torch, fns, iters=30)
            zero = torch.Tensor.zero_
            flush_numel = 96 << 18   # time_cold_ms's flush buffer

            def read_flush(x):
                return (x.sum(), x)[1] if x.numel() == flush_numel \
                    else zero(x)

            torch.Tensor.zero_ = read_flush
            try:
                return cs.time_cold_ms(torch, fns, iters=30)
            finally:
                torch.Tensor.zero_ = zero

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
    if "parent" in parts:
        parent_vs_change(torch, cs, _build, at, da, parent[0])
    return 0


def parent_vs_change(torch, cs, _build, at, da, parent: str) -> None:
    """K1 at the solo prefill, K3 at the solo decode, rows 5 and 6 at the
    bench shape and rows 8 and 11 at the engine's step, cold and warm, each
    timed in turns in one loop as the parent tree's kernels
    (csrc/attention.cu, csrc/decode_attention.cu and csrc/decode_fold.cu
    under ``parent``, built here with the same flags, their entry points
    those of PR 7's tree; rows 8 and 11 there: a split kernel and its
    merge, two launches and a partials buffer) and as this tree's, beside
    SDPA; then the stamped phases of K3 and row 5, the parent's build and
    this tree's."""
    import subprocess

    import torch.nn.functional as F

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "sweep_parent")
    os.makedirs(out, exist_ok=True)
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags,
                               "-o", os.path.join(out, f"lib{n}{tag}.so"),
                               os.path.join(parent, "eamg_tpu_torch", "csrc",
                                            f"{n}.cu")])
             for n, tag, flags in (
                 ("attention", "", ()), ("decode_attention", "", ()),
                 ("decode_attention", "_timed", ("-DEAMG_PHASE_TIMING",)),
                 ("decode_fold", "", ()))]
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed on the parent's sources")
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old_at = ctypes.CDLL(os.path.join(out, "libattention.so"))
    old_da = ctypes.CDLL(os.path.join(out, "libdecode_attention.so"))
    old_df = ctypes.CDLL(os.path.join(out, "libdecode_fold.so"))
    for fn, args in ((old_at.eamg_attention_fwd,
                      [P, P, P, P, P, I, I, I, I, I, I, Fl, I, I, P]),
                     (old_da.eamg_flash_decode_sp,
                      [P, P, P, P, P, I, I, I, I, I, Fl, I, I, I, P]),
                     (old_da.eamg_flash_decode_scalar_t,
                      [P, P, P, P, I, I, I, I, Fl, I, I, I, P]),
                     (old_df.eamg_fold_decode,
                      [P, P, P, P, P, I, I, I, I, I, I, Fl, I, I, P])):
        fn.argtypes, fn.restype = args, ctypes.c_int
    g = torch.Generator().manual_seed(7)
    dt, Dh = torch.bfloat16, 64

    def draw(*shape):
        return torch.randn(*shape, generator=g).to(dt).cuda()

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def report(tag, ms):
        print(f"[parent] {tag}: parent {ms['parent']:.4f} ms, change "
              f"{ms['change']:.4f} ms ({ms['change'] / ms['parent']:.3f} of "
              f"the parent's), sdpa {ms['sdpa']:.4f} ms", flush=True)

    # K1: B 1, H 8, Hkv 2, T 16, causal
    q, k, v = draw(1, 8, 16, Dh), draw(1, 2, 16, Dh), draw(1, 2, 16, Dh)
    vl = torch.full((1,), 16, dtype=torch.int32, device="cuda")
    o = torch.empty_like(q)
    fns = {"parent": lambda: _build.check(old_at.eamg_attention_fwd(
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               vl.data_ptr(), 1, 8, 2, 16, Dh, 1, 1.0 / math.sqrt(Dh),
               at.WARPS, 1, stream()), "parent K1"),
           "change": lambda: at.flash_attention(q, k, v, vl, causal=True),
           "sdpa": lambda: F.scaled_dot_product_attention(
               q, k, v, is_causal=True, enable_gqa=True)}
    fns["parent"]()
    torch.cuda.synchronize()
    print(f"[parent] K1 parent against change, max|diff| "
          f"{(o.float() - fns['change']().float()).abs().max().item():.3e}",
          flush=True)
    report("K1 B 1 H 8 Hkv 2 T 16 cold", cs.time_cold_ms(torch, fns))
    report("K1 B 1 H 8 Hkv 2 T 16 warm",
           {n: cs.time_ms(torch, fn) for n, fn in fns.items()})
    # K3: B 1, H 8, Hkv 2, M 511, t 300 on the card
    M, t = 511, 300
    q, k, v = draw(1, 8, 1, Dh), draw(1, 2, M, Dh), draw(1, 2, M, Dh)
    tt = torch.full((1,), t, dtype=torch.int32, device="cuda")
    o = torch.empty_like(q)
    by_head, C = da.sp_plan(M, Dh, 4, 2, lambda: 0)
    sp_args = (1, 8, 2, M, Dh, 1.0 / math.sqrt(Dh), int(by_head), C, 1)
    fns = {"parent": lambda: _build.check(old_da.eamg_flash_decode_sp(
               q.data_ptr(), k.data_ptr(), v.data_ptr(), tt.data_ptr(),
               o.data_ptr(), *sp_args, stream()), "parent K3"),
           "change": lambda: da.flash_decode_sp(q, k, v, tt),
           "sdpa": lambda: F.scaled_dot_product_attention(
               q, k[:, :, :t + 1], v[:, :, :t + 1], enable_gqa=True)}
    report("K3 B 1 H 8 Hkv 2 M 511 t 300 cold", cs.time_cold_ms(torch, fns))
    report("K3 B 1 H 8 Hkv 2 M 511 t 300 warm",
           {n: cs.time_ms(torch, fn) for n, fn in fns.items()})
    k3 = (q, k, v, tt, o)
    # rows 5 and 6: B 8, MHA H 8, M 511, t 300, C 2
    q, k, v = draw(8, 8, 1, Dh), draw(8, 8, M, Dh), draw(8, 8, M, Dh)
    o = torch.empty_like(q)
    for name, blocked in (("flash_decode", 1), ("flash_decode_vmem", 0)):
        fns = {"parent": lambda b=blocked: _build.check(
                   old_da.eamg_flash_decode_scalar_t(
                       q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), 64, M, Dh, t, 1.0 / math.sqrt(Dh), b, 2,
                       1, stream()), "parent scalar-t"),
               "change": lambda n=name: da._scalar_t(n, q, k, v, t),
               "sdpa": lambda: F.scaled_dot_product_attention(
                   q, k[:, :, :t + 1], v[:, :, :t + 1])}
        report(f"{name} B 8 H 8 M 511 t 300 cold",
               cs.time_cold_ms(torch, fns))
        report(f"{name} B 8 H 8 M 511 t 300 warm",
               {n: cs.time_ms(torch, fn) for n, fn in fns.items()})
    # rows 8 and 11 at the engine's step: B 8, H 8, Hkv 2, M 511, t
    # FOLD_T on the card, a fused cache with a free slot; the parent's
    # variant 0 (row 8) and 1 (row 11), each a split kernel and its merge
    from eamg_tpu_torch.ops import decode_fold as df

    B, H, Hkv = 8, 8, 2
    qf = draw(B, 1, H * Dh)
    kvf = draw(B, M, 2 * Hkv * Dh)
    kvf[0] = 0
    tf = torch.tensor(cs.FOLD_T, dtype=torch.int32, device="cuda")
    of = torch.empty_like(qf)
    part = torch.empty(B * H * -(-M // 64) * (Dh + 2), dtype=torch.float32,
                       device="cuda")
    keep = (torch.arange(M, device="cuda")[None, :]
            <= tf[:, None])[:, None, None, :]
    kh = kvf[..., :Hkv * Dh].reshape(B, M, Hkv, Dh).transpose(1, 2)\
        .contiguous()
    vh = kvf[..., Hkv * Dh:].reshape(B, M, Hkv, Dh).transpose(1, 2)\
        .contiguous()
    qh = qf.reshape(B, H, 1, Dh)
    for name, variant in (("flash_decode_fold_sp", 0),
                          ("flash_decode_fold3_sp", 1)):
        fns = {"parent": lambda var=variant: _build.check(
                   old_df.eamg_fold_decode(
                       qf.data_ptr(), kvf.data_ptr(), tf.data_ptr(),
                       of.data_ptr(), part.data_ptr(), B, H, Hkv, M, Dh,
                       qf.stride(0), 1.0 / math.sqrt(Dh), var, 1, stream()),
                   "parent fold"),
               "change": lambda n=name: getattr(df, n)(qf, kvf, tf, H),
               "sdpa": lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, attn_mask=keep, enable_gqa=True)}
        fns["parent"]()
        torch.cuda.synchronize()
        print(f"[parent] {name} parent against change, max|diff| "
              f"{(of.float() - fns['change']().float()).abs().max().item():.3e}"
              " (p rounded against 128-key blocks in the change only)",
              flush=True)
        tag = f"{name} B 8 H 8 Hkv 2 M 511 t {cs.FOLD_T}"
        report(tag + " cold", cs.time_cold_ms(torch, fns))
        report(tag + " warm", {n: cs.time_ms(torch, fn)
                               for n, fn in fns.items()})
    # K3's and row 5's phases, the parent's stamped build and this tree's
    khz = torch.cuda.get_device_properties(0).clock_rate
    sp_stamps = cs.HEADS_STAMPS if by_head else cs.DECODE_STAMPS
    for tag, path in (("parent", os.path.join(out,
                                              "libdecode_attention_timed.so")),
                      ("change", None)):
        if path is None:
            lib = _build.library("decode_attention_timed")
        else:
            lib = ctypes.CDLL(path)
        for fn, args in ((lib.eamg_set_stamps, [P]),
                         (lib.eamg_flash_decode_scalar_t,
                          [P, P, P, P, I, I, I, I, Fl, I, I, I, P]),
                         (lib.eamg_flash_decode_sp,
                          [P, P, P, P, P, I, I, I, I, I, Fl, I, I, I, P])):
            fn.argtypes, fn.restype = args, ctypes.c_int

        def run_st(lib=lib):
            _build.check(lib.eamg_flash_decode_scalar_t(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 64,
                M, Dh, t, 1.0 / math.sqrt(Dh), 1, 2, 1, stream()),
                "stamped scalar-t")

        def run_sp(lib=lib):
            qs, ks, vs, ts, os_ = k3
            _build.check(lib.eamg_flash_decode_sp(
                qs.data_ptr(), ks.data_ptr(), vs.data_ptr(), ts.data_ptr(),
                os_.data_ptr(), *sp_args, stream()), "stamped K3")
        cs._log_phases(f"{tag} flash_decode C 2, B 8 H 8 M 511 t 300",
                       cs._stamped_runs(torch, lib, run_st, 128,
                                        cs.DECODE_STAMPS, khz), khz)
        cs._log_phases(f"{tag} flash_decode_sp {'by head' if by_head else ''}"
                       f" C {C}, B 1 H 8 Hkv 2 M 511 t 300",
                       cs._stamped_runs(torch, lib, run_sp, 2 * C, sp_stamps,
                                        khz), khz)

if __name__ == "__main__":
    sys.exit(main())
