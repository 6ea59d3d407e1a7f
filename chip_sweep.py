"""The scalar-t cluster kernel of flash_decode and flash_decode_vmem on one
CUDA card, across cluster sizes and cache lengths.

    python3 chip_sweep.py

Times both wrappers' kernel cold (chip_smoke.py's graph replays with the
L2 flushed between them) with C = 1, 2, 4, 8 and 16 blocks a (row, head)
against one library call, SDPA on the keys 0..t, in bf16 at Dh 64: B 8,
H 8 at M 511 (t 300 and 510), 2048 and 4096 (t M - 1), and B 1, H 8 at M
16384 and 60000 (t M - 1); the cluster size the wrapper picks is marked.
Then the bench shape once more with a flush that reads the 384 MB instead
of zeroing them, and the phases of the kernel at C 2 and C 16 from its
stamped build (chip_smoke.py::kernel_phases has the layout), whose entry
skew shows how far apart the card starts the blocks. A cluster size whose
blocks would need more shared memory than the card allows (C 1 at M
60000) is reported as refused. Prints the card line and one line per
measurement; exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import math
import os
import sys


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_sweep: no CUDA device; nothing to run", flush=True)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    from eamg_tpu_torch.ops import _build, decode_attention as da

    print(cs.card_line(), flush=True)
    _build.build_all(["decode_attention", "decode_attention_timed"])
    g = torch.Generator().manual_seed(511)
    dt, Dh, sizes = torch.bfloat16, 64, (1, 2, 4, 8, 16)

    def draw(*shape):
        return torch.randn(*shape, generator=g).to(dt).cuda()

    def timed(q, k, v, t, flush_reads=False):
        fns = {"sdpa": lambda: F.scaled_dot_product_attention(
            q, k[:, :, :t + 1], v[:, :, :t + 1])}
        for name in da.BLOCKED:
            for C in sizes:
                fn = (lambda name=name, C=C: da._scalar_t(name, q, k, v, t,
                                                          C=C))
                try:
                    fn()
                except RuntimeError as exc:   # a block past 227 KB
                    if "shared memory" not in str(exc):
                        raise
                    continue
                fns[(name, C)] = fn
        if not flush_reads:
            return cs.time_cold_ms(torch, fns, iters=30)
        zero = torch.Tensor.zero_
        flush_numel = 96 << 18   # time_cold_ms's flush buffer

        def read_flush(x):
            return (x.sum(), x)[1] if x.numel() == flush_numel else zero(x)

        torch.Tensor.zero_ = read_flush
        try:
            return cs.time_cold_ms(torch, fns, iters=30)
        finally:
            torch.Tensor.zero_ = zero

    def report(tag, M, ms):
        picked = da.scalar_t_cluster_size(
            M, lambda: da.cluster_occupancy(M, Dh, True, dt)[1])
        for name in da.BLOCKED:
            print(f"[sweep] {tag} {name}: " + ", ".join(
                f"C {C}{'*' if C == picked else ''} "
                + (f"{ms[(name, C)]:.4f}" if (name, C) in ms else "refused")
                for C in sizes) + f" ms; SDPA on keys 0..t "
                f"{ms['sdpa']:.4f} ms", flush=True)

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

    # phases at C 2 and C 16, bench shape, t 300, flash_decode's rounding
    q, k, v = bench
    P, I = ctypes.c_void_p, ctypes.c_int
    lib = cs._bind_timed("decode_attention_timed",
                         "eamg_flash_decode_scalar_t",
                         [P, P, P, P, I, I, I, I, _build.F, I, I, I, P])
    khz = torch.cuda.get_device_properties(0).clock_rate
    o = torch.empty_like(q)
    for C in (2, 16):
        def run(C=C):
            _build.check(lib.eamg_flash_decode_scalar_t(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 64,
                511, Dh, 300, 1.0 / math.sqrt(Dh), 1, C, 1,
                torch.cuda.current_stream().cuda_stream), "stamped kernel")
        r = cs._stamped_runs(torch, lib, run, 64 * C, cs.SCALAR_T_STAMPS,
                             khz)
        cs._log_phases(f"flash_decode C {C}, B 8 H 8 M 511 t 300", r, khz)
    return 0


if __name__ == "__main__":
    sys.exit(main())
