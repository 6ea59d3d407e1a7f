"""Smoke test of the PyTorch port on one CUDA card: build, check, serve.

    python3 chip_smoke.py            # one card, no arguments

Phases:
 1. the card's name and power limit (nvidia-smi);
 2. build the four kernels from eamg_tpu_torch/csrc (one nvcc per source,
    in parallel);
 3. hold each kernel against its plain PyTorch version on the card, in f32
    and bf16, at the shapes the main path gives it, and time the kernel,
    the plain version and one PyTorch library call computing the same
    function (a yardstick only: the port never calls it);
 4. teacher-forced f32 logits of the flagship demo_ckpt_a on the card
    (kernels) against the same run on the host (plain versions);
 5. serve POST /generate on demo_ckpt_a in bf16 over HTTP: two WAV requests
    with one seed (their bytes must be equal) and one MIDI request, with
    every kernel's launch count taken over exactly this phase;
 6. trace one more request with torch.profiler: device busy time, idle
    share and the kernels that take the device's time.

Prints a JSON "kernels" line, the card line, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero without that
line. Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
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
}
SOURCES = {
    "flash_attention": "eamg_tpu_torch/csrc/attention.cu",
    "fused_ffn": "eamg_tpu_torch/csrc/ffn.cu",
    "flash_decode": "eamg_tpu_torch/csrc/decode_attention.cu",
    "kth_value": "eamg_tpu_torch/csrc/topk.cu",
}
# The dtype each kernel sees on the main path (bf16 model, f32 head and
# sampling): the kernels line reports each kernel's record at this dtype.
MAIN_DTYPE = {"flash_attention": "bfloat16", "fused_ffn": "bfloat16",
              "flash_decode": "bfloat16", "kth_value": "float32"}
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
       ("kth_value", "float32"): 0.0,
       ("kth_value", "bfloat16"): 0.0}
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


def time_ms(torch, fn, iters: int = 50, cold: bool = False) -> float:
    """Mean device time of fn() over iters launches, by CUDA events. With
    ``cold`` the 50 MB L2 is flushed before each launch (and the flush is
    left out of the time), as the decode loop finds a layer's weights."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if not cold:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / iters
    flush = torch.empty(96 << 18, dtype=torch.float32, device="cuda")
    evs = []
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / iters


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

    from eamg_tpu_torch.ops import attention, decode_attention, ffn, topk

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
        for rows in (1, 16):
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
            record("fused_ffn" if rows == 1 else "fused_ffn_rows16",
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

        # K4: the top-50 threshold of one row over the flagship vocab
        V = 8892
        logits = randn(1, V, dt=dt, scale=3.0)
        logits[0, 100:110] = logits[0, 5]          # ties
        got = topk.kth_value(logits, 50)
        want = topk.kth_value_plain(logits, 50)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        same = torch.equal(got.float().view(torch.int32),
                           want.float().view(torch.int32))
        if not same:
            err = float("inf")
        record("kth_value", dt_name, err,
               time_ms(torch, lambda: topk.kth_value(logits, 50)),
               time_ms(torch, lambda: topk.kth_value_plain(logits, 50)),
               time_ms(torch, lambda: torch.topk(logits, 50).values[..., -1:]),
               nbytes(logits) + 4, 2 * 32 * V, extra="k 50, bit-equal")
    return results


def teacher_forced(torch, ckpt) -> float:
    """Phase 4: f32 logits over a prompt + 64 forced tokens, card vs host."""
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

    def run(device):
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

    a = run("cuda")
    b = run("cpu")
    delta = (a - b).abs().max().item()
    log(f"[teacher-forced] demo_ckpt_a f32, prompt {len(prompt)} + 64 "
        f"forced tokens: max|logits(card) - logits(host)| {delta:.3e} "
        f"(tol {TF_TOL:.0e}, max|logit| {b.abs().max().item():.2f})")
    if not delta <= TF_TOL:
        raise AssertionError(f"teacher-forced delta {delta} > {TF_TOL}")
    return delta


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


def serve(torch) -> dict:
    """Phase 5: POST /generate x3 on demo_ckpt_a, bf16, on the card."""
    from eamg_tpu_torch.ops import attention, decode_attention, ffn, topk
    from eamg_tpu_torch.serve import (make_server, pipeline_from_checkpoint,
                                      serve_forever_in_thread)

    pipe = pipeline_from_checkpoint(device="cuda")
    mods = {"flash_attention": attention, "fused_ffn": ffn,
            "flash_decode": decode_attention, "kth_value": topk}
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = make_server(pipe, "127.0.0.1", port)
    thread = serve_forever_in_thread(server)
    try:
        for m in mods.values():
            m.launches = 0
        reqs = [({"prompt": "I finally got the job, I am so happy!",
                  "seed": "7"}, ""),
                ({"prompt": "I finally got the job, I am so happy!",
                  "seed": "7"}, ""),
                ({"prompt": "The rain will not stop and I miss you.",
                  "seed": "11"}, "?format=midi")]
        bodies = []
        for fields, query in reqs:
            status, data, headers, secs = _post(port, fields, query)
            timings = json.loads(headers.get("X-EAMG-Timings", "{}"))
            n_tok = int(headers.get("X-EAMG-Tokens", "0"))
            dec_s = timings.get("decode", 0.0) / 1000
            log(f"[serve] {query or 'wav'} seed {fields['seed']}: HTTP "
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
            bodies.append(data)
        torch.cuda.synchronize()
        counts = {n: m.launches for n, m in mods.items()}
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if bodies[0] != bodies[1]:
        raise AssertionError("same-seed WAV bytes differ")
    log("[serve] same-seed WAV bytes identical; launches over the three "
        f"requests: {counts}")
    for n, c in counts.items():
        if c <= 0:
            raise AssertionError(f"{n} was not launched on the main path")
    return counts, pipe


def profile(torch, pipe) -> dict:
    """Phase 6: one warm WAV request under torch.profiler. Device busy
    time is the sum of kernel times (one stream, so they do not overlap);
    the idle share is the rest of the request's wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    text = "I finally got the job, I am so happy!"
    pipe.generate(text, seed=7)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = pipe.generate(text, seed=7)
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
                               "kth_value_kernel"),
              "gemm": ("gemm", "xmma", "cutlass", "cublas", "nvjet")}
    by_group = {g: 0.0 for g in (*groups, "other")}
    for key, ms, _ in rows:
        g = next((g for g, pats in groups.items()
                  if any(p in key.lower() for p in pats)), "other")
        by_group[g] += ms
    out = {"wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / wall_ms, "n_tokens": len(res.tokens),
           "timings_ms": res.timings_ms,
           "launches": sum(r[2] for r in rows),
           "device_ms_by_group": by_group,
           "top": [{"kernel": k[:90], "ms": ms, "count": c}
                   for k, ms, c in rows[:12]]}
    log(json.dumps({"profile": out}))
    return out


def main() -> int:
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

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[build] {len(built)} libraries built in "
        f"{time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{n} {s:.1f} s" for n, s in built.items()))

    ckpt = load_checkpoint(DEMO_CKPT_A)
    checks = kernel_checks(torch, ckpt["params"])
    teacher_forced(torch, ckpt)
    counts, pipe = serve(torch)
    profile(torch, pipe)

    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": counts[name],
                "dtype": MAIN_DTYPE[name], **checks[name][MAIN_DTYPE[name]]}
               for name in REPLACES]
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
