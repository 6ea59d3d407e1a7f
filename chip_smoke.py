"""Smoke test of the PyTorch port on one CUDA card: build, check, serve.

    python3 chip_smoke.py            # one card, no arguments
    python3 chip_smoke.py --phases build,kernels    # a part, while developing

Phases:
 1. the card's name and power limit (nvidia-smi);
 2. build: every kernel source in eamg_tpu_torch/csrc (one nvcc per
    source, all in parallel);
 3. kernels: hold each kernel against its plain PyTorch version on the
    card, in f32 and bf16, at the shapes the main paths give it (the solo
    path's and the engine's: 8 rows, ragged lengths), and time the kernel,
    the plain version and one PyTorch library call computing the same
    function (a yardstick only: the port never calls it), each as replays
    of a CUDA graph so that the host's issue rate stays out; then the
    bit-identity of a row alone and inside a batch of 8, for the fold
    kernels, the FFN kernel and the library's matrix product;
 4. teacher: teacher-forced f32 logits of the flagship demo_ckpt_a on the
    card (kernels) against the same run on the host (plain versions), for
    the solo decode and for the ragged decode;
 5. solo: serve POST /generate on demo_ckpt_a in bf16 over HTTP, one
    request at a time: two WAV requests with one seed (their bytes must be
    equal) and one MIDI request, with the launch counts taken over exactly
    this phase; then one more request under torch.profiler;
 6. coalesce: the same server started as `serve --coalesce --slots 8`: one
    lone request (decoded detached, on the engine's own shape), then a
    burst of ten concurrent requests on eight slots, one of them the lone
    request's seed again (its bytes must be equal), with the launch counts
    taken over exactly this phase; the stream-reduce probe and the other
    fold variant run once over the engine's live cache (no served path
    launches these two, so their "launches" are 0 and these launches are
    reported as "probe_launches"); then one more burst under
    torch.profiler; last, four requests at once through `serve --coalesce
    window`, with launch counts of their own.

Prints a JSON "kernels" line, the card line, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero without that
line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

PEAK_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core rate
              "float32": 67e12}      # CUDA cores
REPLACES = {
    "flash_attention": "eamg_tpu/ops/attention.py:114",
    "fused_ffn": "eamg_tpu/ops/ffn.py:61",
    "flash_decode": "eamg_tpu/ops/decode_attention.py:259",
    "kth_value": "eamg_tpu/ops/topk.py:149",
    "flash_decode_fold_sp": "eamg_tpu/ops/decode_fold.py:239",
    "flash_decode_fold3_sp": "eamg_tpu/ops/decode_fold.py:540",
    "stream_reduce": "eamg_tpu/ops/decode_fold.py:565",
}
SOURCES = {
    "flash_attention": "eamg_tpu_torch/csrc/attention.cu",
    "fused_ffn": "eamg_tpu_torch/csrc/ffn.cu",
    "flash_decode": "eamg_tpu_torch/csrc/decode_attention.cu",
    "kth_value": "eamg_tpu_torch/csrc/topk.cu",
    "flash_decode_fold_sp": "eamg_tpu_torch/csrc/decode_fold.cu",
    "flash_decode_fold3_sp": "eamg_tpu_torch/csrc/decode_fold.cu",
    "stream_reduce": "eamg_tpu_torch/csrc/stream_reduce.cu",
}
# The dtype each kernel sees on the main paths (bf16 model, f32 head and
# sampling): the kernels line reports each kernel's record at this dtype.
MAIN_DTYPE = {"flash_attention": "bfloat16", "fused_ffn": "bfloat16",
              "flash_decode": "bfloat16", "kth_value": "float32",
              "flash_decode_fold_sp": "bfloat16",
              "flash_decode_fold3_sp": "bfloat16",
              "stream_reduce": "bfloat16"}
# The path whose launch count is a kernel's "launches": the newest main
# path that runs it. K3 runs on the solo path only; the second fold variant
# and the stream-reduce probe run on no served path, so theirs are 0.
MAIN_PHASE = {"flash_attention": "coalesce", "fused_ffn": "coalesce",
              "kth_value": "coalesce", "flash_decode": "solo",
              "flash_decode_fold_sp": "coalesce",
              "flash_decode_fold3_sp": "coalesce",
              "stream_reduce": "coalesce"}
# what each served path must have launched; "fold_decode" stands for the
# fold kernel that the ragged decode and the engine call
PATH_KERNELS = {"solo": ("flash_attention", "fused_ffn", "flash_decode",
                         "kth_value"),
                "coalesce": ("flash_attention", "fused_ffn", "kth_value",
                             "fold_decode"),
                "window": ("flash_attention", "fused_ffn", "kth_value",
                           "fold_decode")}
ENGINE_SLOTS = 8
# newest valid position per engine row in the kernel checks: a free slot,
# a fresh prompt, both sides of a split boundary, mid-song, the last slot
FOLD_T = (0, 15, 63, 64, 300, 510, 200, 127)
# max |kernel - plain| allowed. f32: both sides accumulate in f32, in other
# orders. bf16: the plain attention rounds scores and probabilities to
# bf16 (the JAX model's XLA path), the kernels keep them in f32, so they
# differ by about one bf16 step of the largest output (2^-8 at |o| ~ 1;
# earlier card runs read 1.6e-2 for K1, 3.9e-3 for K3). top-k: exact.
TOL = {("flash_attention", "float32"): 1e-4,
       ("flash_attention", "bfloat16"): 3e-2,
       ("fused_ffn", "float32"): 1e-4,
       ("fused_ffn", "bfloat16"): 3e-2,
       ("fused_ffn_rows16", "float32"): 1e-4,
       ("fused_ffn_rows16", "bfloat16"): 3e-2,
       ("flash_decode", "float32"): 1e-4,
       ("flash_decode", "bfloat16"): 1e-2,
       ("fused_ffn_rows8", "float32"): 1e-4,
       ("fused_ffn_rows8", "bfloat16"): 3e-2,
       ("kth_value", "float32"): 0.0,
       ("kth_value", "bfloat16"): 0.0,
       ("kth_value_b8", "float32"): 0.0,
       ("kth_value_b8", "bfloat16"): 0.0,
       # the fold kernels as K3: f32 scores and probabilities against the
       # plain version's, rounded to bf16 in the bf16 run
       ("flash_decode_fold_sp", "float32"): 1e-4,
       ("flash_decode_fold_sp", "bfloat16"): 1e-2,
       ("flash_decode_fold3_sp", "float32"): 1e-4,
       ("flash_decode_fold3_sp", "bfloat16"): 1e-2,
       # sums of 4 * 511 values of size ~1 in another order; the bf16
       # output (|sum| up to ~150) is rounded to 2^-8 relative
       ("stream_reduce", "float32"): 1e-3,
       ("stream_reduce", "bfloat16"): 1.0}
# bf16 attention kernels against the plain version run in f32 on the same
# (upcast) inputs: max |err| / max |want|, per decode position for K3. The
# kernels compute in f32 and round only the output (2^-9 relative), so a
# dropped or mis-rescaled key block shows even where outputs are small.
REL_TOL_F32 = 1e-2
TF_TOL = 5e-3   # teacher-forced f32 logits, card vs host (|logit| ~ 10)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def _hold_device(torch, us: float) -> None:
    """Keep the device busy for about ``us`` microseconds, so that the host
    can enqueue what follows before the device gets to it."""
    khz = torch.cuda.get_device_properties(0).clock_rate
    torch.cuda._sleep(int(us * khz / 1000))


def _graphed(torch, fn):
    """fn() captured as a CUDA graph -> the graph's replay: the kernels
    that fn launches, back to back, with no host between them. Timing fn()
    itself would time the host wherever it issues slower than the device
    runs: a wrapper takes the host longer to call than its kernel takes,
    a plain version is a dozen such calls, and the host's speed varies
    between machines and between runs on one machine."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    # thread_local: a serving thread of this process may call the
    # allocator while this thread captures
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        fn()
    return graph.replay


def time_ms(torch, fn, iters: int = 50, cold: bool = False,
            hold_us: float = 1000.0) -> float:
    """Device time of fn() by CUDA events around replays of its graph (see
    :func:`_graphed`): the mean over iters replays back to back, or with
    ``cold`` the median over replays that each find the 50 MB L2 flushed
    (the flush is left out of the time), as the decode loop finds a
    layer's weights."""
    if cold:
        return time_cold_ms(torch, {"fn": fn}, iters, hold_us)["fn"]
    replay = _graphed(torch, fn)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    _hold_device(torch, 20.0 * iters)
    e0.record()
    for _ in range(iters):
        replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def time_cold_ms(torch, fns: dict, iters: int = 50,
                 hold_us: float = 1000.0) -> dict:
    """Median device time of each of ``fns`` (as graphs, see
    :func:`_graphed`) with the L2 flushed before every replay; the device
    is held meanwhile so that the replay is enqueued before it is due.
    The functions take turns, in an order that alternates from round to
    round, so that a drift of the card's clocks or of its neighbours falls
    on all of them alike: two kernels are compared only within one such
    call."""
    flush = torch.empty(96 << 18, dtype=torch.float32, device="cuda")
    names = list(fns)
    replays = {name: _graphed(torch, fns[name]) for name in names}
    evs = {name: [] for name in names}
    for i in range(iters):
        for name in names if i % 2 == 0 else reversed(names):
            flush.zero_()
            _hold_device(torch, hold_us)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            replays[name]()
            e1.record()
            evs[name].append((e0, e1))
        torch.cuda.synchronize()
    out = {}
    for name, pairs in evs.items():
        times = sorted(a.elapsed_time(b) for a, b in pairs)
        out[name] = times[len(times) // 2]
    return out


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_checks(torch, ckpt_params) -> dict:
    """Phase 3. Returns {kernel: {dtype: record}}."""
    import torch.nn.functional as F

    from eamg_tpu_torch.ops import (attention, decode_attention, decode_fold,
                                    ffn, topk)

    dev = "cuda"
    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape, dt, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dt).to(dev)

    results = {}

    def record(name, dt, err, k_ms, p_ms, lib_ms, n_b, flops, extra=""):
        tol = TOL[(name, dt)]
        b_ms, b_by = bound_ms(n_b, flops, dt)
        ok = err <= tol
        log(f"[check] {name:16s} {dt:9s} max|err| {err:.3e} (tol {tol:.0e})"
            f" kernel {k_ms:.4f} ms plain {p_ms:.4f} ms library "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} bound "
            f"{b_ms:.5f} ms ({b_by}) {extra}{'' if ok else '  FAIL'}")
        if not ok:
            raise AssertionError(f"{name} {dt}: max|err| {err} > {tol}")
        results.setdefault(name, {})[dt] = dict(
            max_abs_err=err, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
            bound_ms=b_ms, bound_by=b_by)

    def sdpa(q, k, v, causal):
        return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                              enable_gqa=True)

    def rel_f32(name, got, want32, where=""):
        """bf16 kernel output against the plain version in f32 on the
        upcast inputs: max|err| / max|want|, held to REL_TOL_F32."""
        rel = ((got.float() - want32).abs().max()
               / want32.abs().max().clamp_min(1e-30)).item()
        log(f"[check] {name:16s} bfloat16  vs f32 plain{where}: max|err| / "
            f"max|want| {rel:.3e} (tol {REL_TOL_F32:.0e}, max|want| "
            f"{want32.abs().max().item():.3e})")
        if not rel <= REL_TOL_F32:
            raise AssertionError(f"{name} bf16 vs f32 plain{where}: {rel} > "
                                 f"{REL_TOL_F32}")

    for dt_name, dt in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        # K1: prefill of one prompt bucket, B1 H8 Hkv2 Dh64 T16, causal
        B, H, Hkv, T, Dh = 1, 8, 2, 16, 64
        q = randn(B, H, T, Dh, dt=dt)
        k = randn(B, Hkv, T, Dh, dt=dt)
        v = randn(B, Hkv, T, Dh, dt=dt)
        vl = torch.full((B,), T, dtype=torch.int32, device=dev)
        got = attention.flash_attention(q, k, v, vl, causal=True)
        want = attention.attention_plain(q, k, v, vl, causal=True)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if dt is torch.bfloat16:
            rel_f32("flash_attention", got, attention.attention_plain(
                q.float(), k.float(), v.float(), vl, causal=True))
        pairs = B * H * T * (T + 1) // 2
        record("flash_attention", dt_name, err,
               time_ms(torch, lambda: attention.flash_attention(
                   q, k, v, vl, causal=True)),
               time_ms(torch, lambda: attention.attention_plain(
                   q, k, v, vl, causal=True)),
               time_ms(torch, lambda: sdpa(q, k, v, True)),
               nbytes(q, k, v, q, vl), 4 * pairs * Dh)

        # K2: the flagship's layer-0 FFN, rows 1 (decode) and 16 (prefill)
        mlp = {n: w.to(dt).to(dev) for n, w in
               ckpt_params["layers"][0]["mlp"].items()}
        D, FF = mlp["w2"].shape
        for rows in (1, ENGINE_SLOTS, 16):
            x = randn(rows, D, dt=dt)
            args = (x, mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"])
            got = ffn.fused_ffn(*args, activation="relu")
            want = ffn.ffn_plain(*args, activation="relu")
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()

            def lib(a=args):
                return F.linear(torch.relu(F.linear(a[0], a[1], a[2])),
                                a[3], a[4])

            res = (err, time_ms(torch, lambda: ffn.fused_ffn(
                       *args, activation="relu"), cold=True),
                   time_ms(torch, lambda: ffn.ffn_plain(
                       *args, activation="relu"), cold=True),
                   time_ms(torch, lib, cold=True),
                   nbytes(*args, x), 4 * rows * D * FF)
            record("fused_ffn" if rows == 1 else f"fused_ffn_rows{rows}",
                   dt_name, *res, extra=f"rows {rows}")

        # K3: one decode step over the flagship's 511-slot cache
        M = 511
        kc = randn(1, Hkv, M, Dh, dt=dt)
        vc = randn(1, Hkv, M, Dh, dt=dt)
        q1 = randn(1, H, 1, Dh, dt=dt)
        worst = 0.0
        for t in (0, 15, 300, 510):
            tt = torch.full((1,), t, dtype=torch.int32, device=dev)
            got = decode_attention.flash_decode(q1, kc, vc, tt)
            want = decode_attention.decode_attention_plain(q1, kc, vc, tt)
            torch.cuda.synchronize()
            worst = max(worst, (got.float() - want.float()).abs().max()
                        .item())
            if dt is torch.bfloat16:
                rel_f32("flash_decode", got,
                        decode_attention.decode_attention_plain(
                            q1.float(), kc.float(), vc.float(), tt),
                        where=f" at t {t}")
        t = 300   # timed mid-song
        tt = torch.full((1,), t, dtype=torch.int32, device=dev)
        kv_live = 2 * (t + 1) * Hkv * Dh * kc.element_size()
        record("flash_decode", dt_name, worst,
               time_ms(torch, lambda: decode_attention.flash_decode(
                   q1, kc, vc, tt), cold=True),
               time_ms(torch, lambda: decode_attention
                       .decode_attention_plain(q1, kc, vc, tt), cold=True),
               time_ms(torch, lambda: sdpa(q1, kc[:, :, :t + 1],
                                           vc[:, :, :t + 1], False),
                       cold=True),
               nbytes(q1, q1, tt) + kv_live, 4 * H * (t + 1) * Dh,
               extra=f"M {M}, err over t in (0, 15, 300, 510), timed at "
                     f"t {t}")

        # K4: the top-50 threshold over the flagship vocab, one row (solo)
        # and one per engine slot
        V = 8892
        for nb in (1, ENGINE_SLOTS):
            logits = randn(nb, V, dt=dt, scale=3.0)
            logits[0, 100:110] = logits[0, 5]          # ties
            got = topk.kth_value(logits, 50)
            want = topk.kth_value_plain(logits, 50)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            same = torch.equal(got.float().view(torch.int32),
                               want.float().view(torch.int32))
            if not same:
                err = float("inf")
            record("kth_value" if nb == 1 else f"kth_value_b{nb}", dt_name,
                   err,
                   time_ms(torch, lambda: topk.kth_value(logits, 50)),
                   time_ms(torch, lambda: topk.kth_value_plain(logits, 50)),
                   time_ms(torch, lambda: torch.topk(
                       logits, 50).values[..., -1:]),
                   nbytes(logits) + 4 * nb, 2 * 32 * V * nb,
                   extra=f"B {nb}, k 50, bit-equal")

        # the fold kernels: one engine step, 8 rows over the flagship's
        # fused position-major cache, ragged lengths
        B, D, KVD = ENGINE_SLOTS, H * Dh, Hkv * Dh
        kvc = randn(B, M, 2 * KVD, dt=dt)
        kvc[0] = 0                                  # a free slot: zeros
        qf = randn(B, 1, D, dt=dt)
        tf = torch.tensor(FOLD_T, dtype=torch.int32, device=dev)
        live = sum(t + 1 for t in FOLD_T)
        kv_live = 2 * live * KVD * kvc.element_size()
        want = decode_fold.decode_attention_pm_plain(qf, kvc, tf, H)
        want32 = decode_fold.decode_attention_pm_plain(
            qf.float(), kvc.float(), tf, H)
        # the library yardstick: SDPA on a head-major copy of the cache
        # (made outside the timed call), the lengths as a boolean mask
        kh = kvc[..., :KVD].reshape(B, M, Hkv, Dh).transpose(1, 2)
        vh = kvc[..., KVD:].reshape(B, M, Hkv, Dh).transpose(1, 2)
        kh, vh = kh.contiguous(), vh.contiguous()
        qh = qf.reshape(B, H, 1, Dh)
        keep = (torch.arange(M, device=dev)[None, :]
                <= tf[:, None])[:, None, None, :]

        def sdpa_ragged():
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=keep,
                                                  enable_gqa=True)

        lib = sdpa_ragged().reshape(B, 1, D)
        lib_err = (lib.float() - want32).abs().max().item()
        fold_ms = time_cold_ms(torch, {
            "flash_decode_fold_sp": lambda: decode_fold.flash_decode_fold_sp(
                qf, kvc, tf, H),
            "flash_decode_fold3_sp": lambda: decode_fold.flash_decode_fold3_sp(
                qf, kvc, tf, H),
            "plain": lambda: decode_fold.decode_attention_pm_plain(
                qf, kvc, tf, H),
            "library": sdpa_ragged})
        p_ms, lib_ms = fold_ms["plain"], fold_ms["library"]
        for name in ("flash_decode_fold_sp", "flash_decode_fold3_sp"):
            fn = getattr(decode_fold, name)
            got = fn(qf, kvc, tf, H)
            torch.cuda.synchronize()
            if not torch.isfinite(got.float()).all() or \
                    got[0].abs().max().item() != 0.0:
                raise AssertionError(f"{name}: a free slot (t 0 over zeros) "
                                     "must give zeros")
            err = (got.float() - want.float()).abs().max().item()
            if dt is torch.bfloat16:
                for b, t in enumerate(FOLD_T):
                    if b:   # row 0 is all zeros
                        rel_f32(name, got[b], want32[b], where=f" at t {t}")
            # a strided q: the head of a fused QKV projection
            qkv = torch.cat([qf, randn(B, 1, 2 * KVD, dt=dt)], dim=-1)
            if not torch.equal(fn(qkv[..., :D], kvc, tf, H), got):
                raise AssertionError(f"{name}: strided q differs")
            record(name, dt_name, err, fold_ms[name],
                   p_ms, lib_ms, nbytes(qf, qf, tf) + kv_live,
                   4 * H * live * Dh,
                   extra=f"B {B}, M {M}, t {FOLD_T}; library max|err| vs f32 "
                         f"plain {lib_err:.1e}")

        # stream reduce: the read-rate probe over one layer's engine cache
        rows = 4
        kvs = randn(B, M, 2 * KVD, dt=dt)
        got = decode_fold.stream_reduce(kvs, rows)
        want = decode_fold.stream_reduce_plain(kvs, rows)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        k_ms = time_ms(torch, lambda: decode_fold.stream_reduce(kvs, rows),
                       cold=True)
        record("stream_reduce", dt_name, err, k_ms,
               time_ms(torch, lambda: decode_fold.stream_reduce_plain(
                   kvs, rows), cold=True),
               time_ms(torch, lambda: kvs[B - rows:].sum(
                   dim=(0, 1), dtype=torch.float32), cold=True),
               nbytes(kvs) + 2 * KVD * kvs.element_size(), kvs.numel(),
               extra=f"kv {tuple(kvs.shape)}, rows {rows}: reads "
                     f"{nbytes(kvs) / k_ms / 1e6:.1f} GB/s (the plain and "
                     "library versions read the last group only)")
    return results


def bit_identity(torch, ckpt_params) -> dict:
    """Phase 3, second part: does a row get the same bits alone and inside
    a batch of 8? The engine's contract rests on it for the kernels (they
    must), and it is reported for the library's matrix product (which need
    not: the engine and its detached route therefore share one shape)."""
    import torch.nn.functional as F

    from eamg_tpu_torch.ops import decode_fold, ffn

    dev, dt = "cuda", torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(5)
    B, M, H, Dh, Hkv = ENGINE_SLOTS, 511, 8, 64, 2
    D, KVD = H * Dh, Hkv * Dh
    kv = torch.randn(B, M, 2 * KVD, generator=g).to(dt).to(dev)
    q = torch.randn(B, 1, D, generator=g).to(dt).to(dev)
    t = torch.tensor(FOLD_T, dtype=torch.int32, device=dev)
    out = {}
    for name in ("flash_decode_fold_sp", "flash_decode_fold3_sp"):
        fn = getattr(decode_fold, name)
        full = fn(q, kv, t, H)
        same = all(torch.equal(fn(q[b:b + 1], kv[b:b + 1], t[b:b + 1], H)[0],
                               full[b]) for b in range(B))
        out[name] = same
    mlp = {n: w.to(dt).to(dev) for n, w in
           ckpt_params["layers"][0]["mlp"].items()}
    x = torch.randn(B, 1, D, generator=g).to(dt).to(dev)
    args = (mlp["w1"], mlp["b1"], mlp["w2"], mlp["b2"])
    full = ffn.fused_ffn(x, *args, activation="relu")
    out["fused_ffn"] = all(torch.equal(
        ffn.fused_ffn(x[b:b + 1], *args, activation="relu")[0], full[b])
        for b in range(B))
    attn = ckpt_params["layers"][0]["attn"]
    w, bias = attn["in_w"].to(dt).to(dev), attn["in_b"].to(dt).to(dev)
    full = F.linear(x, w, bias)
    out["library_matmul"] = all(torch.equal(F.linear(x[b:b + 1], w, bias)[0],
                                            full[b]) for b in range(B))
    torch.cuda.synchronize()
    log(f"[bit-identity] bf16, a row alone against the row inside a batch "
        f"of {B}: {out}")
    for name in ("flash_decode_fold_sp", "flash_decode_fold3_sp",
                 "fused_ffn"):
        if not out[name]:
            raise AssertionError(f"{name}: a row's bits depend on the batch")
    return out


def teacher_forced(torch, ckpt) -> float:
    """Phase 4: f32 logits over a prompt + 64 forced tokens, card vs host,
    through the solo decode and through the ragged decode (batch of 3 with
    prompts of other lengths beside it)."""
    from eamg_tpu_torch.decode import ragged
    from eamg_tpu_torch.decode.api import _to_device
    from eamg_tpu_torch.models.gpt import decode_step, init_kv_cache, \
        prefill

    cfg = dataclasses.replace(ckpt["cfg"], dtype="float32")
    vocab = ckpt["vocab"]
    prompt = [vocab[t] for t in ("[START_SEQUENCE]", "[BPM] 120.0",
                                 "[KEY_SIGNATURE] C major",
                                 "[INSTRUMENT] Acoustic Grand Piano")]
    g = torch.Generator().manual_seed(1)
    forced = torch.randint(0, cfg.vocab_size, (64,), generator=g).tolist()
    P = 16
    ids = torch.zeros((1, P), dtype=torch.int64)
    ids[0, :len(prompt)] = torch.tensor(prompt)
    ids3 = torch.randint(0, cfg.vocab_size, (3, P), generator=g)
    ids3[1] = ids[0]
    lens3 = torch.tensor([9, len(prompt), 16], dtype=torch.int32)

    def run_solo(device):
        params = _to_device(ckpt["params"], device)
        cache = init_kv_cache(cfg, 1, 511, device=device)
        logits0, cache = prefill(params, ids.to(device), cfg, cache,
                                 prompt_len=len(prompt))
        outs = [logits0[0, :len(prompt)]]
        last = prompt[-1]
        for tok in forced:
            lg, cache = decode_step(params, torch.tensor([[last]],
                                                         device=device),
                                    cache, cfg)
            outs.append(lg)
            last = tok
        return torch.cat(outs).float().cpu()

    def run_ragged(device):
        params = _to_device(ckpt["params"], device)
        cache = ragged.init_ragged_cache(cfg, 3, 511, device=device)
        logits0, cache = ragged.prefill_ragged(
            params, ids3.to(device), lens3.to(device), cfg, cache)
        outs = [logits0[1, :len(prompt)]]
        last = ids3[torch.arange(3), (lens3 - 1).long()].to(device)
        for tok in forced:
            lg, cache = ragged.decode_step_ragged(params, last, cache, cfg)
            outs.append(lg[1:2])
            last = torch.full_like(last, tok)
        return torch.cat(outs).float().cpu()

    worst = 0.0
    for name, run in (("solo", run_solo), ("ragged", run_ragged)):
        a, b = run("cuda"), run("cpu")
        delta = (a - b).abs().max().item()
        log(f"[teacher-forced] demo_ckpt_a f32 {name} decode, prompt "
            f"{len(prompt)} + 64 forced tokens: max|logits(card) - "
            f"logits(host)| {delta:.3e} (tol {TF_TOL:.0e}, max|logit| "
            f"{b.abs().max().item():.2f})")
        if not delta <= TF_TOL:
            raise AssertionError(f"teacher-forced {name} delta {delta} > "
                                 f"{TF_TOL}")
        worst = max(worst, delta)
    return worst


def _post(port: int, fields: dict, query: str = ""):
    boundary = "eamgsmokeboundary"
    body = b"".join(
        f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'
        f"\r\n\r\n{v}\r\n".encode() for k, v in fields.items())
    body += f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate{query}", data=body,
        headers={"Content-Type": f"multipart/form-data; boundary={boundary}"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        data = r.read()
        return r.status, data, dict(r.headers), time.perf_counter() - t0


def _check_reply(tag, fields, query, reply) -> int:
    """Log one reply and hold it to the contract; returns its token count."""
    status, data, headers, secs = reply
    timings = json.loads(headers.get("X-EAMG-Timings", "{}"))
    n_tok = int(headers.get("X-EAMG-Tokens", "0"))
    dec_s = timings.get("decode", 0.0) / 1000
    log(f"[{tag}] {query or 'wav'} seed {fields['seed']}: HTTP "
        f"{status}, {len(data)} bytes, {secs * 1000:.1f} ms, "
        f"emotion {headers.get('X-EAMG-Emotion')}, {n_tok} tokens "
        f"(prompt included), {n_tok / dec_s if dec_s else 0:.1f} "
        f"tokens/s of decode, timings_ms {timings}")
    if status != 200:
        raise AssertionError(f"HTTP {status}")
    if query:
        if data[:4] != b"MThd":
            raise AssertionError("MIDI reply does not start MThd")
    elif data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AssertionError("WAV reply is not RIFF....WAVE")
    return n_tok


def _serving(pipe):
    """(server, thread, port) for a pipeline on a free local port."""
    from eamg_tpu_torch.serve import make_server, serve_forever_in_thread

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = make_server(pipe, "127.0.0.1", port)
    return server, serve_forever_in_thread(server), port


def _require_launched(path: str, counts: dict) -> None:
    from eamg_tpu_torch.ops import decode_fold

    for n in PATH_KERNELS[path]:
        if n == "fold_decode":
            n = decode_fold.fold_decode.__name__
        if counts.get(n, 0) <= 0:
            raise AssertionError(f"{n} was not launched on the {path} path")


def serve_solo(torch):
    """Phase 5: POST /generate x3 on demo_ckpt_a, bf16, on the card, one
    request at a time through the solo decode."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve import shutdown_gracefully

    pipe = cli.pipeline_from_args(cli.parse_args(["serve"]))
    server, thread, port = _serving(pipe)
    try:
        _build.reset_launch_counts()
        reqs = [({"prompt": "I finally got the job, I am so happy!",
                  "seed": "7"}, ""),
                ({"prompt": "I finally got the job, I am so happy!",
                  "seed": "7"}, ""),
                ({"prompt": "The rain will not stop and I miss you.",
                  "seed": "11"}, "?format=midi")]
        bodies = []
        for fields, query in reqs:
            reply = _post(port, fields, query)
            _check_reply("solo", fields, query, reply)
            bodies.append(reply[1])
        torch.cuda.synchronize()
        counts = _build.launch_counts()
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    if bodies[0] != bodies[1]:
        raise AssertionError("same-seed WAV bytes differ")
    log("[solo] same-seed WAV bytes identical; launches over the three "
        f"requests: {counts}")
    _require_launched("solo", counts)
    return counts, pipe


def _trace(torch, tag: str, work) -> dict:
    """Run work() under torch.profiler. Device busy time is the sum of
    kernel times (one stream, so they do not overlap); the idle share is
    the rest of the wall time. work() returns the number of tokens made."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        n_tokens = work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and e.device_type.name == "CUDA":
            rows.append((e.key, us / 1000, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    groups = {"port kernels": ("attn_fwd", "ffn_partial", "ffn_reduce",
                               "decode_partial", "decode_combine",
                               "kth_value_kernel", "fold_partial",
                               "fold_combine", "stream_partial",
                               "stream_final"),
              "gemm": ("gemm", "xmma", "cutlass", "cublas", "nvjet")}
    by_group = {g: 0.0 for g in (*groups, "other")}
    for key, ms, _ in rows:
        g = next((g for g, pats in groups.items()
                  if any(p in key.lower() for p in pats)), "other")
        by_group[g] += ms
    launches = sum(r[2] for r in rows)
    out = {"path": tag, "wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms, "n_tokens": n_tokens,
           "launches": launches,
           "launches_per_token": launches / max(n_tokens, 1),
           "device_ms_by_group": by_group,
           "top": [{"kernel": k[:90], "ms": ms, "count": c}
                   for k, ms, c in rows[:12]]}
    if not busy > 0:
        raise AssertionError("the trace shows no device time")
    log(json.dumps({"profile": out}))
    return out


def profile_solo(torch, pipe) -> dict:
    """Phase 5, second part: one warm WAV request under torch.profiler."""
    text = "I finally got the job, I am so happy!"
    pipe.generate(text, seed=7)
    torch.cuda.synchronize()
    return _trace(torch, "solo",
                  lambda: len(pipe.generate(text, seed=7).tokens))


BURST_TEXTS = ("I finally got the job, I am so happy!",
               "The rain will not stop and I miss you.",
               "Why would they do that to me, I am furious.",
               "It is a quiet evening and the tea is warm.")
LONE = {"prompt": BURST_TEXTS[0], "seed": "21"}


def _burst(port: int, tag: str, lone_again: bool):
    """Ten concurrent requests on eight slots: eight at once (with
    ``lone_again`` the third of them is the lone request's prompt and seed
    again, as WAV), then a ninth and a tenth a moment later, which find the
    decode running. -> (tokens, seconds, the repeated request's bytes)."""
    replies, errors = {}, []

    def hit(i, delay, fields, query):
        try:
            time.sleep(delay)
            replies[i] = (fields, query, _post(port, fields, query))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {type(exc).__name__}: {exc}")

    plan = []
    for i in range(10):
        fields = {"prompt": BURST_TEXTS[i % len(BURST_TEXTS)],
                  "seed": str(31 + i)}
        query = "?format=midi" if i % 2 else ""
        if lone_again and i == 2:
            fields, query = dict(LONE), ""
        plan.append((i, 0.02 * i if i < 8 else 0.4 + 0.1 * i, fields, query))
    t0 = time.perf_counter()
    threads = [threading.Thread(target=hit, args=a, daemon=True)
               for a in plan]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    secs = time.perf_counter() - t0
    if errors or len(replies) != len(plan):
        raise AssertionError(f"burst failed: {errors or 'a request hung'}")
    n_tok = sum(_check_reply(tag, f, q, r)
                for _, (f, q, r) in sorted(replies.items()))
    return n_tok, secs, replies[2][2][1]


def serve_coalesced(torch):
    """Phase 6: the server as `serve --coalesce --slots 8` on demo_ckpt_a,
    bf16, full width: a lone request, then the burst; the probes on the
    engine's cache; one more burst under torch.profiler."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.ops import _build, decode_fold
    from eamg_tpu_torch.serve import shutdown_gracefully

    pipe = cli.pipeline_from_args(cli.parse_args(
        ["serve", "--coalesce", "--slots", str(ENGINE_SLOTS)]))
    eng = pipe.batcher
    engine_fold = decode_fold.fold_decode.__name__
    log(f"[coalesce] engine: slots {eng.slots}, chunk {eng.chunk}, max_len "
        f"{eng.max_len}, decode attention {engine_fold}")
    pipe.warmup()
    server, thread, port = _serving(pipe)
    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        # (a) a lone request: the idle engine is bypassed, run_detached
        lone = _post(port, LONE, "")
        _check_reply("coalesce lone", LONE, "", lone)
        if eng.stats["admitted"] != 0:
            raise AssertionError("the lone request did not take the "
                                 "detached route")
        # (b) + (c) ten requests on eight slots, the lone seed among them
        n_tok, secs, again = _burst(port, "coalesce burst", lone_again=True)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as r:
            stats = json.loads(r.read())["engine"]
        log(f"[coalesce] burst of 10: {n_tok} tokens (prompts included) in "
            f"{secs:.2f} s, {n_tok / secs:.1f} tokens/s aggregate; engine "
            f"stats {stats}")
        if again != lone[1]:
            raise AssertionError("the lone request's seed gave other bytes "
                                 "inside the burst")
        log("[coalesce] the lone request's bytes are the same inside the "
            "burst (detached row == engine row)")
        if stats["served"] < 8 or stats["served"] != stats["admitted"]:
            raise AssertionError(f"engine served {stats}")
        log(f"[coalesce] launches over the lone request and the burst: "
            f"{counts}")
        _require_launched("coalesce", counts)

        # The probes, once each on the engine's live cache (layer 0): the
        # read rate that bounds the fold kernels, and the fold variant the
        # engine does not call. No served path launches these two: their
        # launches here are counted apart, as probe launches.
        cache = eng.state["cache"]
        kv, t = cache["kv"][0], cache["lengths"]
        H = pipe.generator.cfg.n_head
        g = torch.Generator(device="cpu").manual_seed(3)
        q = torch.randn(kv.shape[0], 1, pipe.generator.cfg.d_model,
                        generator=g).to(kv.dtype).to(kv.device)
        before = _build.launch_counts()
        outs = {n: getattr(decode_fold, n)(q, kv, t, H)
                for n in ("flash_decode_fold_sp", "flash_decode_fold3_sp")
                if n != engine_fold}
        decode_fold.stream_reduce(kv, 4)
        after = _build.launch_counts()
        probes = {n: after.get(n, 0) - before.get(n, 0)
                  for n in (*outs, "stream_reduce")}
        if min(probes.values()) <= 0:
            raise AssertionError(f"a probe did not launch: {probes}")
        outs[engine_fold] = decode_fold.fold_decode(q, kv, t, H)
        want = decode_fold.decode_attention_pm_plain(q.float(), kv.float(), t,
                                                     H)
        rel = max((o.float() - want).abs().max().item()
                  for o in outs.values()) / max(want.abs().max().item(),
                                                1e-30)
        probe_ms = time_cold_ms(torch, {
            "stream": lambda: decode_fold.stream_reduce(kv, 4),
            "fold": lambda: decode_fold.fold_decode(q, kv, t, H)},
            iters=30, hold_us=2000.0)
        sr_ms, f_ms = probe_ms["stream"], probe_ms["fold"]
        live = int((t.clamp(max=kv.shape[1] - 1) + 1).sum().item())
        log(f"[coalesce] on the engine's cache after the burst (layer 0, "
            f"{tuple(kv.shape)}, lengths {t.tolist()}): both fold variants "
            f"vs f32 plain max|err| / max|want| {rel:.2e} (tol "
            f"{REL_TOL_F32:.0e}); stream_reduce {sr_ms:.4f} ms = "
            f"{nbytes(kv) / sr_ms / 1e6:.1f} GB/s over the whole cache; "
            f"engine fold kernel {f_ms:.4f} ms for {live} live positions")
        if not rel <= REL_TOL_F32:
            raise AssertionError(f"fold variants on the engine cache: {rel}")

        # one more burst under torch.profiler
        prof = _trace(torch, "coalesce",
                      lambda: _burst(port, "coalesce traced",
                                     lone_again=False)[0])
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    return counts, probes, prof


def serve_window(torch) -> dict:
    """Phase 6, last part: the other coalescing mode, `serve --coalesce
    window`: four requests at once share ragged decodes of the window
    batcher (grouped by their sampling params). -> launches per kernel
    over the four requests."""
    from eamg_tpu_torch import cli
    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve import shutdown_gracefully

    pipe = cli.pipeline_from_args(cli.parse_args(
        ["serve", "--coalesce", "window", "--slots", "4"]))
    pipe.warmup()
    server, thread, port = _serving(pipe)
    replies, errors = {}, []

    def hit(i):
        fields = {"prompt": BURST_TEXTS[i], "seed": str(51 + i)}
        try:
            replies[i] = (fields, _post(port, fields, "?format=midi"))
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"request {i}: {type(exc).__name__}: {exc}")

    try:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=hit, args=(i,), daemon=True)
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        secs = time.perf_counter() - t0
        if errors or len(replies) != 4:
            raise AssertionError(f"window batch failed: "
                                 f"{errors or 'a request hung'}")
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        n_tok = sum(_check_reply("window", f, "?format=midi", r)
                    for _, (f, r) in sorted(replies.items()))
        stats = dict(pipe.batcher.stats)
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    log(f"[window] 4 requests at once: {n_tok} tokens in {secs:.2f} s, "
        f"{n_tok / secs:.1f} tokens/s aggregate; batcher stats {stats}; "
        f"launches over the four requests: {counts}")
    if stats["requests"] < 5 or stats["max_group"] < 2:
        raise AssertionError(f"the window batcher did not group: {stats}")
    _require_launched("window", counts)
    return counts


PHASES = ("build", "kernels", "teacher", "solo", "coalesce")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of " + ",".join(PHASES)
                             + " (default: all; only the full run prints "
                             "the kernels line and the last line)")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        parser.error(f"phases are {PHASES}")

    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing to run")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    from eamg_tpu_torch.ops import _build
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_A
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    t_start = time.perf_counter()
    if "build" in phases:
        t0 = time.perf_counter()
        built = _build.build_all()
        log(f"[build] {len(built)} libraries built in "
            f"{time.perf_counter() - t0:.1f} s: "
            + ", ".join(f"{n} {s:.1f} s" for n, s in built.items()))

    ckpt = load_checkpoint(DEMO_CKPT_A)
    checks, counts, probes = {}, {}, {}
    if "kernels" in phases:
        checks = kernel_checks(torch, ckpt["params"])
        bit_identity(torch, ckpt["params"])
    if "teacher" in phases:
        teacher_forced(torch, ckpt)
    if "solo" in phases:
        counts["solo"], pipe = serve_solo(torch)
        profile_solo(torch, pipe)
        del pipe
    if "coalesce" in phases:
        counts["coalesce"], probes, _ = serve_coalesced(torch)
        counts["window"] = serve_window(torch)
    log(f"[done] phases {phases} in {time.perf_counter() - t_start:.1f} s")
    if list(phases) != list(PHASES):
        log("chip_smoke: a partial run; no kernels line and no last line")
        return 0

    kernels = []
    for name in REPLACES:
        rec = checks[name][MAIN_DTYPE[name]]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": counts[MAIN_PHASE[name]].get(name, 0),
            "launches_by_path": {p: c.get(name, 0)
                                 for p, c in counts.items()},
            "probe_launches": probes.get(name, 0),
            "dtype": MAIN_DTYPE[name], **rec})
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        code = 1
    sys.exit(code)
