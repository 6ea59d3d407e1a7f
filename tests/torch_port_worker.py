"""The PyTorch side of the port's parity tests, run in a SUBPROCESS.

torch must not enter the pytest process (tests/conftest.py), so the
tests/test_torch_*.py files write their inputs (made with numpy from a
seed, and JAX parameter trees as numpy arrays) to an .npz, run

    python tests/torch_port_worker.py TASK IN.npz OUT.npz

with the repository root as cwd and PYTHONPATH, and compare OUT.npz with
the JAX package's results. Every check of one test file is one TASK, so a
file pays for one torch import. Everything runs on the CPU, where the
port's kernel wrappers take their plain versions.

Keys of the npz files are "/"-joined paths into nested dicts and lists
(``p/layers/0/attn/in_w``); see :func:`unflatten`.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

import numpy as np
import torch

CPU = "cpu"


def unflatten(npz, prefix: str):
    """Rebuild the nested tree stored under ``prefix/``: integer path
    parts are list indices."""
    root: dict = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]

    def fix(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [fix(n[str(i)]) for i in range(len(n))]
        return {k: fix(v) for k, v in n.items()}

    return fix(root)


def _t(a, bf16: bool = False):
    """numpy -> tensor; with ``bf16`` a uint16 array is read as the bit
    patterns of bfloat16 values."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if bf16 and t.dtype == torch.uint16 else t


def _np(t):
    """tensor -> numpy, bf16 as float32 (exact)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _raised(fn) -> np.ndarray:
    """The class and message of what fn() raises, or "none"."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the test reads the name
        return np.asarray(f"{type(e).__name__}: {e}")
    return np.asarray("none")


def _cfg(npz, key):
    from eamg_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(**json.loads(str(npz[key])))


# ------------------------------------------------------------------ kernels

def _cluster_launches(decode_fold, shapes) -> dict:
    """What flash_decode_fold, _fold2 and _fold3 hand the library on CUDA
    inputs, recorded in place of a launch: for each shape (B, n_head,
    kv_heads, M, Dh, dtype, C resident clusters of 16) a JSON list of the
    library, the symbol and the arguments, and the launch counts after
    all. Meta tensors stand for the card's (no data, pointers 0); the
    library, the stream and the device check are stood in for, so the
    wrappers' own code runs as it does on the card."""
    from unittest import mock

    from eamg_tpu_torch.ops import _build

    calls = []

    def bind(lib, fn, argtypes):
        def call(*args):
            if fn == "eamg_fold_cluster_occupancy":
                args[-1][0] = active16
            else:
                calls.append([lib, fn, list(args)])
            return 0
        return call

    def fresh():
        for f in (decode_fold._launch_cluster, decode_fold._launch_occupancy,
                  decode_fold.cluster_occupancy):
            f.cache_clear()

    got = {}
    fresh()
    _build.reset_launch_counts()
    try:
        with mock.patch.object(_build, "bind", bind), \
                mock.patch.object(_build, "stream_ptr", lambda t: 0), \
                mock.patch.object(decode_fold, "_check_fold",
                                  lambda *a: None):
            for i, (B, H, Hkv, M, Dh, dt, active16) in enumerate(shapes):
                fresh()
                dt = getattr(torch, dt)
                q = torch.empty((B, 1, H * Dh), dtype=dt, device="meta")
                kv = torch.empty((B, M, 2 * Hkv * Dh), dtype=dt,
                                 device="meta")
                t = (torch.arange(B, dtype=torch.int32) * 7 % M).to("meta")
                for name in ("flash_decode_fold", "flash_decode_fold2",
                             "flash_decode_fold3"):
                    calls.clear()
                    getattr(decode_fold, name)(q, kv, t, H)
                    got[f"clusterlaunch/{i}/{name}"] = np.asarray(
                        json.dumps(calls))
        got["clusterlaunch/counts"] = np.asarray(
            json.dumps(_build.launch_counts()))
    finally:
        fresh()
        _build.reset_launch_counts()
    return got


def _scalar_t_launches(decode_attention, shapes) -> dict:
    """What flash_decode and flash_decode_vmem hand the library on CUDA
    inputs, recorded in place of a launch, as :func:`_cluster_launches`
    records the fold wrappers': for each shape (B, H, M, Dh, dtype, t,
    resident clusters of 16), t a one-element int32 tensor on the inputs'
    device (each tensor's pointer a distinct multiple of 16), a JSON list
    of the library, the symbol and the arguments, and t's pointer; what
    each wrapper says of a host int t on those inputs; and the launch
    counts after all."""
    from unittest import mock

    from eamg_tpu_torch.ops import _build

    calls = []

    def ptr(t):
        return 16 * (id(t) % (1 << 40))

    def bind(lib, fn, argtypes):
        def call(*args):
            if fn == "eamg_decode_cluster_occupancy":
                args[-1][0] = active16
            else:
                calls.append([lib, fn, list(args)])
            return 0
        return call

    def fresh():
        for f in (decode_attention._launch_scalar_t,
                  decode_attention._launch_occupancy,
                  decode_attention.cluster_occupancy):
            f.cache_clear()

    got = {}
    fresh()
    _build.reset_launch_counts()
    try:
        with mock.patch.object(_build, "bind", bind), \
                mock.patch.object(_build, "stream_ptr", lambda t: 0), \
                mock.patch.object(decode_attention, "_check_card",
                                  lambda *a: None), \
                mock.patch.object(torch.Tensor, "data_ptr", ptr):
            for i, (B, H, M, Dh, dt, t, active16) in enumerate(shapes):
                fresh()
                dt = getattr(torch, dt)
                q = torch.empty((B, H, 1, Dh), dtype=dt, device="meta")
                kv = torch.empty((B, H, M, Dh), dtype=dt, device="meta")
                td = torch.empty((1,), dtype=torch.int32, device="meta")
                got[f"scalartlaunch/{i}/tptr"] = np.asarray(ptr(td))
                for name in ("flash_decode", "flash_decode_vmem"):
                    calls.clear()
                    getattr(decode_attention, name)(q, kv, kv, td)
                    got[f"scalartlaunch/{i}/{name}"] = np.asarray(
                        json.dumps(calls))
                    got[f"scalartlaunch/{i}/{name}/host_t"] = _raised(
                        lambda: getattr(decode_attention, name)(q, kv, kv,
                                                                t))
        got["scalartlaunch/counts"] = np.asarray(
            json.dumps(_build.launch_counts()))
    finally:
        fresh()
        _build.reset_launch_counts()
    return got


def _card_launches(cases) -> dict:
    """What K3 (flash_decode_sp) and K1 (flash_attention) hand the library
    on CUDA inputs, recorded in place of a launch: meta tensors stand for
    the card's (a wrapper that read one on the host would raise), each
    tensor's pointer is a distinct multiple of 16, and the device check
    is passed. For each case a JSON list of [library, symbol, arguments]
    (the occupancy query answered with the case's resident clusters of
    16), the pointers of the case's tensors by name, or what the wrapper
    raised; and the launch counts after all."""
    from unittest import mock

    from eamg_tpu_torch.ops import _build, attention, decode_attention

    calls = []
    active16 = [0]

    def bind(lib, fn, argtypes):
        def call(*args):
            if fn == "eamg_decode_cluster_occupancy":
                args[-1][0] = active16[0]
            else:
                calls.append([lib, fn, list(args)])
            return 0
        return call

    def fresh():
        for f in (decode_attention._launch, decode_attention._launch_occupancy,
                  decode_attention.cluster_occupancy, attention._launch):
            f.cache_clear()

    def ptr(t):
        return 16 * (id(t) % (1 << 40))

    got = {}
    fresh()
    _build.reset_launch_counts()
    try:
        with mock.patch.object(_build, "bind", bind), \
                mock.patch.object(_build, "stream_ptr", lambda t: 0), \
                mock.patch.object(_build, "require_cuda", lambda *a: None), \
                mock.patch.object(torch.Tensor, "data_ptr", ptr):
            for i, case in enumerate(cases):
                fresh()
                calls.clear()
                kind, B, H, Hkv, L, Dh, dt, act = case
                active16[0] = act
                dt = getattr(torch, dt)
                q = torch.empty((B, H, 1 if kind == "sp" else L, Dh),
                                dtype=dt, device="meta")
                k = torch.empty((B, Hkv, L, Dh), dtype=dt, device="meta")
                v = torch.empty((B, Hkv, L, Dh), dtype=dt, device="meta")
                lens = torch.empty((B,), dtype=torch.int32, device="meta")
                if kind == "sp":
                    said = _raised(lambda: decode_attention.flash_decode_sp(
                        q, k, v, lens))
                else:
                    said = _raised(lambda: attention.flash_attention(
                        q, k, v, lens, causal=True))
                got[f"cardlaunch/{i}"] = np.asarray(json.dumps(calls))
                got[f"cardlaunch/{i}/raised"] = said
                got[f"cardlaunch/{i}/ptrs"] = np.asarray(json.dumps(
                    {n: ptr(x) for n, x in (("q", q), ("k", k), ("v", v),
                                            ("lens", lens))}))
        got["cardlaunch/counts"] = np.asarray(
            json.dumps(_build.launch_counts()))
    finally:
        fresh()
        _build.reset_launch_counts()
    return got


def _fold_sp_launches(cases) -> dict:
    """What flash_decode_fold_sp and flash_decode_fold3_sp hand the
    library on CUDA inputs, recorded in place of a launch, as
    :func:`_card_launches` records K3's: meta tensors stand for the card's,
    each tensor's pointer a distinct multiple of 16, the device check
    passed (the rest of the argument check runs). For each case (B, H, Hkv,
    M, Dh, dtype, resident clusters of 16), q is the head of a fused QKV
    projection (rows D + 2 KVD apart), and each wrapper is called at B and
    at B 1, with t a [B] int32 tensor and with one-element int32 tensors
    labelled 0, M - 1 and M + 100 (meta tensors hold no value): a JSON list
    of [label, library, symbol, arguments] a call and the pointers of q,
    kv and t by label, or what the first call raised; what each wrapper
    says of a host int t; and the launch counts after all."""
    from unittest import mock

    from eamg_tpu_torch.ops import _build, decode_attention, decode_fold

    calls = []
    active16 = [0]

    def bind(lib, fn, argtypes):
        def call(*args):
            if fn == "eamg_decode_cluster_occupancy":
                args[-1][0] = active16[0]
            else:
                calls.append([label[0], lib, fn, list(args)])
            return 0
        return call

    def fresh():
        for f in (decode_fold._launch_sp, decode_attention._launch_occupancy,
                  decode_attention.cluster_occupancy):
            f.cache_clear()

    def ptr(t):
        return 16 * (id(t) % (1 << 40))

    label = [""]
    got = {}
    fresh()
    _build.reset_launch_counts()
    try:
        with mock.patch.object(_build, "bind", bind), \
                mock.patch.object(_build, "stream_ptr", lambda t: 0), \
                mock.patch.object(_build, "require_cuda", lambda *a: None), \
                mock.patch.object(torch.Tensor, "data_ptr", ptr):
            for i, (B, H, Hkv, M, Dh, dt, act) in enumerate(cases):
                fresh()
                calls.clear()
                active16[0] = act
                dt = getattr(torch, dt)
                D, KVD = H * Dh, Hkv * Dh
                ptrs, said = {}, np.asarray("none")
                for b in (B, 1):
                    qkv = torch.empty((b, 1, D + 2 * KVD), dtype=dt,
                                      device="meta")
                    q = qkv[..., :D]
                    kv = torch.empty((b, M, 2 * KVD), dtype=dt, device="meta")
                    tb = torch.empty((b,), dtype=torch.int32, device="meta")
                    for t in (tb, 0, M - 1, M + 100):
                        tl = "rows" if t is tb else f"t{t}"
                        if t is not tb:
                            t = torch.empty((1,), dtype=torch.int32,
                                            device="meta")
                        for name in ("flash_decode_fold_sp",
                                     "flash_decode_fold3_sp"):
                            label[0] = f"B{b}/{tl}/{name}"
                            ptrs[label[0]] = {"q": ptr(q), "kv": ptr(kv),
                                              "t": ptr(tb)}
                            r = _raised(lambda: getattr(decode_fold, name)(
                                q, kv, t, H))
                            if str(said) == "none":
                                said = r
                got[f"foldsp/{i}"] = np.asarray(json.dumps(calls))
                got[f"foldsp/{i}/raised"] = said
                got[f"foldsp/{i}/host_t"] = _raised(
                    lambda: decode_fold.flash_decode_fold_sp(q, kv, 3, H))
                got[f"foldsp/{i}/ptrs"] = np.asarray(json.dumps(ptrs))
        got["foldsp/counts"] = np.asarray(json.dumps(_build.launch_counts()))
    finally:
        fresh()
        _build.reset_launch_counts()
    return got


def task_kernels(inp, out):
    from eamg_tpu_torch.ops import (attention, decode_attention, decode_fold,
                                    ffn, topk)

    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("attn/")}):
        a = unflatten(inp, f"attn/{name}")
        vl = _t(a["valid_len"]) if "valid_len" in a else None
        out[f"attn/{name}"] = attention.flash_attention(
            _t(a["q"]), _t(a["k"]), _t(a["v"]), vl,
            causal=bool(a["causal"])).numpy()
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("ffn/")}):
        a = unflatten(inp, f"ffn/{name}")
        out[f"ffn/{name}"] = ffn.fused_ffn(
            _t(a["x"]), _t(a["w1"]), _t(a["b1"]), _t(a["w2"]), _t(a["b2"]),
            activation=str(a["activation"])).numpy()
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("dec/")}):
        a = unflatten(inp, f"dec/{name}")
        out[f"dec/{name}"] = decode_attention.flash_decode_sp(
            _t(a["q"]), _t(a["k"]), _t(a["v"]), _t(a["t"])).numpy()
    # the two scalar-t kernels' wrappers (MHA caches, t by value)
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("dec1/")}):
        a = unflatten(inp, f"dec1/{name}")
        bf = bool(a["bf16"])
        for entry in ("flash_decode", "flash_decode_vmem"):
            out[f"dec1/{name}/{entry}"] = _np(getattr(
                decode_attention, entry)(_t(a["q"], bf), _t(a["k"], bf),
                                         _t(a["v"], bf), int(a["t"])))
    # the three one-launch fold kernels' wrappers
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("whole/")}):
        a = unflatten(inp, f"whole/{name}")
        bf = bool(a["bf16"])
        t = a["t"]
        t = int(t) if t.ndim == 0 else _t(t)
        args = (_t(a["q"], bf), _t(a["kv"], bf), t, int(a["n_head"]))
        out[f"whole/{name}/flash_decode_fold"] = _np(
            decode_fold.flash_decode_fold(*args))
        out[f"whole/{name}/flash_decode_fold3"] = _np(
            decode_fold.flash_decode_fold3(*args))
        for rows in a["rows"]:
            out[f"whole/{name}/flash_decode_fold2/rows{int(rows)}"] = _np(
                decode_fold.flash_decode_fold2(*args, rows=int(rows)))
    if "refuse/q" in inp.files:
        a = unflatten(inp, "refuse")
        q, k, v = _t(a["q"]), _t(a["k"]), _t(a["v"])
        out["refuse/gqa"] = _raised(lambda: decode_attention.flash_decode(
            q, k[:, :2], v[:, :2], 3))
        out["refuse/gqa_vmem"] = _raised(
            lambda: decode_attention.flash_decode_vmem(q, k[:, :2], v[:, :2],
                                                       3))
        out["refuse/t_rows"] = _raised(lambda: decode_attention.flash_decode(
            q, k, v, torch.tensor([3, 4], dtype=torch.int32)))
        out["refuse/rows"] = _raised(lambda: decode_fold.flash_decode_fold2(
            _t(a["fq"]), _t(a["fkv"]), 3, 4, rows=3))
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("topk/")}):
        a = unflatten(inp, f"topk/{name}")
        out[f"topk/{name}"] = topk.kth_value(_t(a["logits"]),
                                             int(a["k"])).numpy()
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("topp/")}):
        a = unflatten(inp, f"topp/{name}")
        out[f"topp/{name}"] = topk.top_p_threshold(_t(a["logits"]),
                                                   float(a["p"])).numpy()
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("fold/")}):
        a = unflatten(inp, f"fold/{name}")
        t = a["t"]
        t = int(t) if t.ndim == 0 else _t(t)
        for entry in ("flash_decode_fold_sp", "flash_decode_fold3_sp"):
            out[f"fold/{name}/{entry}"] = getattr(decode_fold, entry)(
                _t(a["q"]), _t(a["kv"]), t, int(a["n_head"])).numpy()
    # the cluster size picked from resident clusters, and the arguments
    # each wrapper of the cluster kernel hands the library
    if "plan/resident" in inp.files:
        out["plan/sizes"] = np.asarray(
            [decode_fold.cluster_size(int(n)) for n in inp["plan/resident"]])
    if "clusterlaunch/shapes" in inp.files:
        out.update(_cluster_launches(
            decode_fold, json.loads(str(inp["clusterlaunch/shapes"]))))
    # the scalar-t cluster kernel: each block's keys and the 256-key blocks
    # they touch, the cluster size picked, and its wrappers' arguments
    if "spans/cases" in inp.files:
        for i, (t, M, C) in enumerate(json.loads(str(inp["spans/cases"]))):
            spans = decode_attention.key_spans(t, M, C)
            out[f"spans/{i}"] = np.asarray(spans, np.int64).reshape(-1, 2)
            out[f"spans/{i}/blocks"] = np.asarray(json.dumps(
                [list(decode_attention.span_blocks(
                    a, b, decode_attention.BLOCK_K["flash_decode"]))
                 for a, b in spans]))
    if "scalartsize/cases" in inp.files:
        out["scalartsize/got"] = np.asarray([
            decode_attention.cluster_size(int(M), 1, lambda n=n: int(n))
            for M, n in inp["scalartsize/cases"]])
    # K3: each row's spans from a t [B] (as the kernel reads it), the
    # 128-key blocks they touch, the cluster size picked from (M, g), and
    # K1's and K3's launch arguments
    if "rowspans/cases" in inp.files:
        for i, (ts, M, C) in enumerate(json.loads(str(inp["rowspans/cases"]))):
            t = torch.tensor(ts, dtype=torch.int32)
            for b in range(t.shape[0]):
                spans = decode_attention.key_spans(int(t[b]), M, C)
                out[f"rowspans/{i}/{b}"] = np.asarray(spans,
                                                      np.int64).reshape(-1, 2)
                out[f"rowspans/{i}/{b}/blocks"] = np.asarray(json.dumps(
                    [list(decode_attention.span_blocks(
                        a, z, decode_attention.BLOCK_K["flash_decode_sp"]))
                     for a, z in spans]))
    if "spsize/cases" in inp.files:
        out["spsize/got"] = np.asarray([
            decode_attention.cluster_size(int(M), int(g),
                                             lambda n=n: int(n))
            for M, g, n in inp["spsize/cases"]])
    if "spplan/cases" in inp.files:
        out["spplan/got"] = np.asarray([
            decode_attention.sp_plan(int(M), int(Dh), int(g), int(es),
                                     lambda n=n: int(n))
            for M, Dh, g, es, n in inp["spplan/cases"]])
    if "cardlaunch/cases" in inp.files:
        out.update(_card_launches(json.loads(str(inp["cardlaunch/cases"]))))
    if "foldsp/cases" in inp.files:
        out.update(_fold_sp_launches(json.loads(str(inp["foldsp/cases"]))))
    if "scalartlaunch/shapes" in inp.files:
        out.update(_scalar_t_launches(
            decode_attention, json.loads(str(inp["scalartlaunch/shapes"]))))
    # K2's plan for each (D, FF), the names of ffn_plan's parameters, and
    # what its argument check says of each case
    if "ffnplan/shapes" in inp.files:
        import inspect

        for D, FF in inp["ffnplan/shapes"]:
            plan = ffn.ffn_plan(int(D), int(FF))
            key = f"ffnplan/{int(D)}_{int(FF)}"
            out[f"{key}/slices"] = np.asarray(plan.slices, np.int64)
            out[f"{key}/panel"] = np.asarray(plan.panel)
            out[f"{key}/scratch"] = np.asarray(plan.scratch_per_row)
        out["ffnplan/params"] = np.asarray(
            list(inspect.signature(ffn.ffn_plan).parameters))
    if "ffncheck/cases" in inp.files:
        for case, spec in json.loads(str(inp["ffncheck/cases"])).items():
            shape, FF, dt, bdt, act = spec[:5]
            dt, bdt = getattr(torch, dt), getattr(torch, bdt)
            D = shape[-1]
            x = torch.zeros(shape, dtype=dt)
            w1 = torch.zeros((FF, D + (case.endswith("w1_shape"))),
                             dtype=dt)
            w2 = torch.zeros((D, FF), dtype=dt)
            b1 = torch.zeros((FF,), dtype=bdt)
            b2 = torch.zeros((D + case.endswith("b2_shape"),), dtype=bdt)
            out[f"ffncheck/{case}"] = _raised(
                lambda: ffn.check_args(x, w1, b1, w2, b2, act))
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("stream/")}):
        a = unflatten(inp, f"stream/{name}")
        out[f"stream/{name}"] = decode_fold.stream_reduce(
            _t(a["kv"]), int(a["rows"])).numpy()


# -------------------------------------------------------------------- topk
def _wrapper_launches(cases) -> dict:
    """K4's two entry points, the sampler's top-k and the stream-reduce
    probe on CUDA inputs, recorded in place of a launch: meta tensors stand
    for the card's (each tensor's pointer a distinct multiple of 16), the
    device check passed, the rest of each wrapper's argument check run.
    Each case is [label, wrapper, shape, dtype, k or rows]: a JSON list of
    [library, symbol, arguments] a call, the pointers of the input and of
    what came back, and what the call raised; then the launch counts."""
    from unittest import mock

    from eamg_tpu_torch.decode import sampling
    from eamg_tpu_torch.ops import _build, decode_fold, topk

    calls = []

    def bind(lib, fn, argtypes):
        def call(*args):
            calls.append([lib, fn, list(args)])
            return 0
        return call

    def ptr(t):
        return 16 * (id(t) % (1 << 40))

    wrappers = {"kth_value": topk.kth_value, "top_k_mask": topk.top_k_mask,
                "apply_top_k": sampling.apply_top_k,
                "stream_reduce": decode_fold.stream_reduce}
    fresh = (topk._launch, decode_fold._launch_stream,
             decode_fold._stream_scratch)
    got = {}
    for f in fresh:
        f.cache_clear()
    _build.reset_launch_counts()
    try:
        with mock.patch.object(_build, "bind", bind), \
                mock.patch.object(_build, "stream_ptr", lambda t: 0), \
                mock.patch.object(_build, "require_cuda", lambda *a: None), \
                mock.patch.object(torch.Tensor, "data_ptr", ptr):
            for label, name, shape, dt, arg in cases:
                calls.clear()
                x = torch.empty(shape, dtype=getattr(torch, dt),
                                device="meta")
                if label.endswith("strided"):
                    x = x.transpose(-1, -2)
                res = []

                def run():
                    res.append(wrappers[name](x, arg))

                got[f"wrap/{label}/raised"] = _raised(run)
                got[f"wrap/{label}"] = np.asarray(json.dumps(calls))
                got[f"wrap/{label}/ptrs"] = np.asarray(json.dumps(
                    [ptr(x), ptr(res[0]) if res else 0]))
                got[f"wrap/{label}/out"] = np.asarray(json.dumps(
                    [list(res[0].shape), str(res[0].dtype)] if res else []))
        got["wrap/counts"] = np.asarray(json.dumps(_build.launch_counts()))
    finally:
        for f in fresh:
            f.cache_clear()
        _build.reset_launch_counts()
    return got


def task_topk(inp, out):
    from eamg_tpu_torch.decode import sampling
    from eamg_tpu_torch.ops import decode_fold, topk

    logits = _t(inp["mask/logits"])
    for k in inp["mask/ks"]:
        for i, m in enumerate(inp["mask/values"]):
            out[f"mask/plain/k{int(k)}/m{i}"] = topk.top_k_mask_plain(
                logits, int(k), float(m)).numpy()
            out[f"mask/sampler/k{int(k)}/m{i}"] = sampling.apply_top_k(
                logits, int(k), float(m)).numpy()
    for name in sorted({k.split("/")[1] for k in inp.files
                        if k.startswith("stream/")}):
        a = unflatten(inp, f"stream/{name}")
        out[f"stream/{name}"] = decode_fold.stream_reduce(
            _t(a["kv"]), int(a["rows"])).numpy()
    out.update(_wrapper_launches(json.loads(str(inp["wrap/cases"]))))


# -------------------------------------------------------------------- slice

def _model_checks(inp, out, tag):
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    cfg = _cfg(inp, f"{tag}/cfg")
    params = params_from_jax(unflatten(inp, f"{tag}/p"))
    ids = _t(inp[f"{tag}/ids"]).long()
    out[f"{tag}/forward"] = gpt.forward(params, ids, cfg).numpy()
    plen = int(inp[f"{tag}/plen"])
    cache = gpt.init_kv_cache(cfg, ids.shape[0], int(inp[f"{tag}/max_len"]))
    logits, cache = gpt.prefill(params, ids, cfg, cache, prompt_len=plen)
    out[f"{tag}/prefill"] = logits.numpy()
    steps = []
    last = ids[:, plen - 1:plen]
    for tok in inp[f"{tag}/forced"]:
        lg, cache = gpt.decode_step(params, last, cache, cfg)
        steps.append(lg.numpy())
        last = torch.full_like(last, int(tok))
    out[f"{tag}/decode"] = np.stack(steps)
    prompt = _t(inp[f"{tag}/gen_prompt"]).long()
    gplen = int(inp[f"{tag}/gen_plen"])
    max_len = int(inp[f"{tag}/gen_max_len"])
    buf, n = generate_kv(params, prompt, gplen, prng.PRNGKey(0), cfg,
                         max_len, greedy=True, eos_id=int(inp["eos"]))
    out[f"{tag}/greedy"] = buf[:, :n].numpy()
    for seed in inp["seeds"]:
        buf, n = generate_kv(params, prompt, gplen, prng.PRNGKey(int(seed)),
                             cfg, max_len, top_k=int(inp["top_k"]),
                             temperature=float(inp["temperature"]),
                             eos_id=int(inp["eos"]))
        out[f"{tag}/sampled{int(seed)}"] = buf[:, :n].numpy()
    f = json.loads(str(inp["filters"]))
    buf, n = generate_kv(params, prompt, gplen, prng.PRNGKey(f["seed"]), cfg,
                         max_len, top_k=f["top_k"],
                         temperature=f["temperature"], top_p=f["top_p"],
                         min_p=f["min_p"], eos_id=int(inp["eos"]),
                         presplit_keys=True)
    out[f"{tag}/filtered"] = buf[:, :n].numpy()


def _prng_checks(inp, out):
    from eamg_tpu_torch.utils import prng

    for seed in inp["prng_seeds"]:
        seed = int(seed)
        key = prng.PRNGKey(seed)
        out[f"prng/{seed}/key"] = np.asarray(key, np.uint32)
        out[f"prng/{seed}/split2"] = np.asarray(prng.split(key), np.uint32)
        out[f"prng/{seed}/split5"] = np.asarray(prng.split(key, 5),
                                                np.uint32)
        for i, shape in enumerate(json.loads(str(inp["prng_shapes"]))):
            out[f"prng/{seed}/bits{i}"] = prng.bits(key, shape).numpy() \
                .astype(np.uint32)
            out[f"prng/{seed}/uniform{i}"] = prng.uniform(
                key, shape, -2.0, 3.0).numpy()
        out[f"prng/{seed}/categorical"] = prng.categorical(
            key, _t(inp["prng_logits"])).numpy()


def _flagship_checks(inp, out):
    import dataclasses

    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_A
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(DEMO_CKPT_A)
    shapes = []
    flat = [("", ck["params"])]
    while flat:
        path, node = flat.pop()
        if isinstance(node, dict):
            flat.extend((f"{path}/{k}", v) for k, v in node.items())
        elif isinstance(node, list):
            flat.extend((f"{path}/{i}", v) for i, v in enumerate(node))
        else:
            shapes.append(f"{path}:{tuple(node.shape)}:"
                          f"{str(node.dtype).replace('torch.', '')}")
    out["flagship/shapes"] = np.asarray(sorted(shapes))
    cfg = dataclasses.replace(ck["cfg"], dtype="float32")
    out["flagship/logits"] = gpt.forward(
        ck["params"], _t(inp["flagship/ids"]).long(), cfg).numpy()


def _classifier_checks(inp, out):
    from eamg_tpu_torch.emotion import EmotionClassifier

    clf = EmotionClassifier(device=CPU)
    texts = json.loads(str(inp["clf/texts"]))
    out["clf/probs"] = np.stack([clf._probs(t) for t in texts])
    out["clf/labels"] = np.asarray([clf.predict(t) for t in texts])
    lex = EmotionClassifier(backend="lexicon", device=CPU)
    out["clf/lexicon"] = np.asarray([lex.predict(t) for t in texts])


def _song(spec):
    from eamg_tpu_torch.midi.smf import Instrument, MidiSong, Note

    song = MidiSong()
    for prog, drum, notes in spec:
        inst = Instrument(program=prog, is_drum=drum)
        inst.notes.extend(Note(v, p, s, e) for v, p, s, e in notes)
        song.instruments.append(inst)
    return song


def _synth_checks(inp, out):
    from eamg_tpu_torch.audio.synth import render_song

    song = _song(json.loads(str(inp["synth/song"])))
    out["synth/wave"] = render_song(song, seed=int(inp["synth/seed"]),
                                    device=CPU)


def _pipeline(inp):
    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.emotion import EmotionClassifier
    from eamg_tpu_torch.serve import Pipeline
    from eamg_tpu_torch.tokenizer import Vocab
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    gen = Generator(params_from_jax(unflatten(inp, "pipe/p")),
                    _cfg(inp, "pipe/cfg"),
                    Vocab(json.loads(str(inp["pipe/vocab"]))), device=CPU)
    return Pipeline(gen, EmotionClassifier(device=CPU))


def _pipeline_checks(inp, out, pipe):
    for i, (text, seed) in enumerate(json.loads(str(inp["pipe/requests"]))):
        r = pipe.generate(text, seed=seed, render_audio=False)
        out[f"pipe/{i}/midi"] = np.frombuffer(r.midi_bytes, np.uint8)
        out[f"pipe/{i}/label"] = np.asarray(r.label)


def _server_checks(out, pipe):
    """POST /generate on the CPU pipeline: the HTTP contract."""
    import socket
    import urllib.error
    import urllib.parse
    import urllib.request

    from eamg_tpu_torch.serve import make_server, serve_forever_in_thread

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    server = make_server(pipe, "127.0.0.1", port)
    thread = serve_forever_in_thread(server)

    def call(method, path, fields=None):
        data = urllib.parse.urlencode(fields).encode() if fields else None
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=data, method=method)
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    try:
        calls = {
            "wav": ("POST", "/generate", {"prompt": "so happy", "seed": 3}),
            "midi": ("POST", "/generate?format=midi",
                     {"prompt": "so happy", "seed": 3}),
            "stream": ("POST", "/generate", {"prompt": "x", "stream": "1"}),
            "beams": ("POST", "/generate", {"prompt": "x", "beams": "4"}),
            "penalty": ("POST", "/generate",
                        {"prompt": "x", "repetition_penalty": "1.3"}),
            "ngram": ("POST", "/generate?format=midi",
                      {"prompt": "x", "no_repeat_ngram": "2",
                       "presence_penalty": "0.2"}),
            "bad_ngram": ("POST", "/generate",
                          {"prompt": "x", "no_repeat_ngram": "9"}),
            "bad_seed": ("POST", "/generate", {"prompt": "x",
                                               "seed": "abc"}),
            "no_prompt": ("POST", "/generate", {"seed": "1"}),
            "healthz": ("GET", "/healthz", None),
            "stats": ("GET", "/stats", None),
            "profile": ("GET", "/profile", None),
        }
        for name, (method, path, fields) in calls.items():
            status, body = call(method, path, fields)
            out[f"http/{name}/status"] = np.asarray(status)
            out[f"http/{name}/head"] = np.frombuffer(body[:12], np.uint8)
            if status >= 400:
                out[f"http/{name}/error"] = np.asarray(
                    json.loads(body)["error"])
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post_form(port, fields, query="", timeout=300):
    import urllib.error
    import urllib.parse
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate{query}",
        data=urllib.parse.urlencode(fields).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _cli_coalesce_checks(inp, out):
    """`python -m eamg_tpu_torch.cli serve --coalesce` as its own process."""
    import os
    import signal
    import subprocess
    import time
    import urllib.request

    ckpt = str(inp["co/ckpt"])
    eng = json.loads(str(inp["co/engine"]))
    reqs = json.loads(str(inp["co/requests"]))
    from eamg_tpu_torch import cli

    import eamg_tpu_torch.serve as serve_pkg

    for flag, value in (("--engine-medusa", None), ("--engine-grammar", None),
                        ("--engine-ngram", "3")):
        args = cli.parse_args(["serve", "--coalesce", flag]
                              + ([value] if value else []))
        out[f"cli/{flag}/opts"] = np.asarray(json.dumps(
            cli.coalesce_opts_from_args(args)))
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            refused = cli._refuse(args, cli._ENGINE_NOT_YET)
        out[f"cli/{flag}/code"] = np.asarray(2 if refused else 0)
        out[f"cli/{flag}/stderr"] = np.asarray(err.getvalue())
        # what `serve` hands the pipeline for the flag
        seen = {}
        real = serve_pkg.pipeline_from_checkpoint
        serve_pkg.pipeline_from_checkpoint = lambda *a, **k: seen.update(k)
        try:
            cli.pipeline_from_args(args)
        finally:
            serve_pkg.pipeline_from_checkpoint = real
        out[f"cli/{flag}/engine_medusa"] = np.asarray(
            bool(seen.get("engine_medusa")))
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "eamg_tpu_torch.cli", "serve", "--device",
         "cpu", "--checkpoint", ckpt, "--host", "127.0.0.1", "--port",
         str(port), "--coalesce", "--slots", str(eng["slots"]), "--chunk",
         str(eng["chunk"])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONUNBUFFERED": "1"})
    try:
        deadline = time.monotonic() + WAIT
        while True:
            assert proc.poll() is None, proc.stdout.read()[-3000:]
            assert time.monotonic() < deadline, "the server did not start"
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=5):
                    break
            except OSError:
                time.sleep(0.2)
        replies = {}

        def hit(i):
            text, seed, extra = reqs[i]
            replies[i] = _post_form(port, {"prompt": text, "seed": seed,
                                           **extra}, "?format=midi")

        concurrent = [i for i, r in enumerate(reqs) if not r[2]]
        _threads(hit, [(i,) for i in concurrent])
        for i in range(len(reqs)):
            if i not in concurrent:
                hit(i)
        for i, (status, body, _) in replies.items():
            out[f"co/{i}/status"] = np.asarray(status)
            out[f"co/{i}/midi"] = np.frombuffer(body, np.uint8)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=30) as r:
            out["co/stats"] = np.asarray(r.read().decode())
        proc.send_signal(signal.SIGTERM)
        tail, _ = proc.communicate(timeout=WAIT)
        out["co/exit_code"] = np.asarray(proc.returncode)
        out["co/tail"] = np.asarray(tail[-400:])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def _overload_checks(inp, out):
    """A one-slot engine with one place in its queue, under eight requests
    at once: some are served, the others get 503 + Retry-After."""
    from eamg_tpu_torch.emotion import EmotionClassifier
    from eamg_tpu_torch.serve import (make_server, pipeline_from_checkpoint,
                                      serve_forever_in_thread,
                                      shutdown_gracefully)

    pipe = pipeline_from_checkpoint(
        str(inp["co/ckpt"]), device=CPU, coalesce="continuous",
        classifier=EmotionClassifier(backend="lexicon", device=CPU),
        coalesce_opts={"slots": 1, "chunk": 8, "max_queue": 1})
    port = _free_port()
    server = make_server(pipe, "127.0.0.1", port)
    thread = serve_forever_in_thread(server)
    replies = {}

    def hit(i):
        replies[i] = _post_form(port, {"prompt": "so happy", "seed": i},
                                "?format=midi")

    try:
        _threads(hit, [(i,) for i in range(8)])
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)
    out["overload/statuses"] = np.asarray([replies[i][0] for i in range(8)])
    shed = [r for r in replies.values() if r[0] == 503]
    if shed:
        out["overload/retry_after"] = np.asarray(shed[0][2].get(
            "Retry-After", ""))
        out["overload/error"] = np.asarray(json.loads(shed[0][1])["error"])
    out["overload/rejected"] = np.asarray(pipe.batcher.stats["rejected"])


def task_slice(inp, out):
    for tag in json.loads(str(inp["model_tags"])):
        _model_checks(inp, out, tag)
    _prng_checks(inp, out)
    _flagship_checks(inp, out)
    _classifier_checks(inp, out)
    _synth_checks(inp, out)
    pipe = _pipeline(inp)
    _pipeline_checks(inp, out, pipe)
    _server_checks(out, pipe)
    _cli_coalesce_checks(inp, out)
    _overload_checks(inp, out)


# -------------------------------------------------------------------- batch

def _gen_kwargs(spec: dict) -> dict:
    spec = dict(spec)
    spec.pop("seed", None)
    if "penalties" in spec:
        spec["penalties"] = tuple(spec["penalties"])
    return spec


def _batch_model_checks(inp, out, tag):
    """One model of tests/test_torch_batch.py: the fused prefill, a
    teacher-forced decode and every generation case, per attn_impl."""
    from eamg_tpu_torch.decode.loop import generate_full, generate_kv
    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import (fused_cache_from_jax,
                                                 params_from_jax)

    cfg = _cfg(inp, f"{tag}/cfg")
    params = params_from_jax(unflatten(inp, f"{tag}/p"))
    impls = json.loads(str(inp[f"{tag}/impls"]))
    prompt = _t(inp[f"{tag}/prompt"]).long()
    plen, max_len = int(inp[f"{tag}/plen"]), int(inp[f"{tag}/max_len"])
    forced = inp[f"{tag}/forced"]
    for impl in impls:
        cache = gpt.init_kv_cache(cfg, prompt.shape[0], max_len,
                                  layout=gpt.cache_layout(impl, cfg))
        logits, cache = gpt.prefill(params, prompt, cfg, cache,
                                    prompt_len=plen)
        out[f"{tag}/{impl}/prefill"] = logits.numpy()
        if "kv" in cache:
            out.update(flatten_out([kv.numpy().copy()
                                    for kv in cache["kv"]],
                                   f"{tag}/{impl}/cache0"))
        steps, last = [], prompt[:, plen - 1:plen]
        for row in forced:
            lg, cache = gpt.decode_step(params, last, cache, cfg, impl)
            steps.append(lg.numpy())
            last = _t(row).long()[:, None]
        out[f"{tag}/{impl}/decode"] = np.stack(steps)
        assert cache["length"] == plen + len(forced)
    jc = fused_cache_from_jax(unflatten(inp, f"{tag}/jax_cache0"))
    out.update(flatten_out([kv.numpy() for kv in jc["kv"]],
                           f"{tag}/jax_cache0"))
    out[f"{tag}/jax_cache0_length"] = np.asarray(jc["length"])
    eos = int(inp["eos"])
    for name, spec in json.loads(str(inp[f"{tag}/cases"])).items():
        for impl in impls:
            buf, n = generate_kv(params, prompt, plen,
                                 prng.PRNGKey(spec.get("seed", 0)), cfg,
                                 max_len, eos_id=eos, attn_impl=impl,
                                 **_gen_kwargs(spec))
            out[f"{tag}/{name}/{impl}"] = buf[:, :n].numpy()
    for name, spec in json.loads(str(inp[f"{tag}/full_cases"])).items():
        buf, n = generate_full(params, prompt, plen,
                               prng.PRNGKey(spec.get("seed", 0)), cfg,
                               int(inp[f"{tag}/full_max_len"]), eos_id=eos,
                               **_gen_kwargs(spec))
        out[f"{tag}/full/{name}"] = buf[:, :n].numpy()
    if cfg.kv_heads != cfg.n_head:
        for impl in ("dma", "vmem"):
            out[f"{tag}/refuse/{impl}"] = _raised(lambda: generate_kv(
                params, prompt, plen, prng.PRNGKey(0), cfg, max_len,
                attn_impl=impl))
    out[f"{tag}/refuse/unknown"] = _raised(lambda: generate_kv(
        params, prompt, plen, prng.PRNGKey(0), cfg, max_len,
        attn_impl="paged"))
    return params, cfg


def _sampling_checks(inp, out):
    from eamg_tpu_torch.decode import sampling
    from eamg_tpu_torch.utils import prng

    logits = _t(inp["smp/logits"])
    ids, valid = _t(inp["smp/ids"]).long(), _t(inp["smp/valid"])
    V = logits.shape[1]
    counts = sampling.token_counts(ids, valid, V)
    out["smp/counts"] = counts.numpy()
    buf = _t(inp["smp/buf"]).long()
    for n in (1, 2, 3):
        for pname, pos in (("scalar", int(inp["smp/pos"])),
                           ("rows", _t(inp["smp/pos_rows"]))):
            out[f"smp/ban{n}/{pname}"] = sampling.no_repeat_ngram_ban(
                buf, pos, n, V).numpy()
    out["smp/ngram_logits"] = sampling.apply_no_repeat_ngram(
        logits, buf, int(inp["smp/pos"]), 2).numpy()
    for name, pen in json.loads(str(inp["smp/penalties"])).items():
        out[f"smp/pen/{name}"] = sampling.apply_penalties(
            logits, counts, *pen).numpy()
        key = prng.PRNGKey(int(inp["smp/seed"]))
        for greedy in (False, True):
            out[f"smp/tok/{name}/{int(greedy)}"] = sampling.sample_token(
                key, logits, 0.8, 10, greedy=greedy, top_p=0.9, min_p=0.01,
                counts=counts, repetition_penalty=pen[0],
                frequency_penalty=pen[1], presence_penalty=pen[2]).numpy()


def _generator_checks(inp, out, params, cfg):
    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.tokenizer import SchemeB2, Vocab, detect_scheme

    vocab = Vocab({f"t{i}": i for i in range(cfg.vocab_size)})
    gen = Generator(params, cfg, vocab, eos_token=f"t{int(inp['eos'])}",
                    pad_token="t0", device=CPU)
    out["gen/max_supported"] = np.asarray(
        [gen.max_supported_len(), gen.max_supported_len(use_cache=False)])
    ids = [int(i) for i in inp["gen/prompt_ids"]]
    for name, kw in json.loads(str(inp["gen/calls"])).items():
        if "penalties" in kw:
            kw["penalties"] = tuple(kw["penalties"])
        out[f"gen/{name}"] = gen.generate_ids(ids, **kw)
    toks = [f"t{i}" for i in ids]
    out["gen/sample"] = np.asarray(gen.vocab.encode(
        gen.sample(toks, max_len=20, seed=2, top_k=15)))
    out["gen/sample_kvcache"] = np.asarray(gen.vocab.encode(
        gen.sample_kvcache(toks, max_len=20, seed=2, top_k=15,
                           penalties=(1.2, 0.0, 0.1), no_repeat_ngram=2)))
    from eamg_tpu_torch.decode.grammar import grammar_a

    out["gen/grammar"] = gen.generate_ids(
        ids, max_len=24, seed=2, top_k=15, grammar=grammar_a(
            Vocab(json.loads(str(inp["gen/grammar_names"])))))
    b2 = SchemeB2()
    out["tok/b2_vocab"] = np.asarray(len(b2.vocab))
    out["tok/schemes"] = np.asarray([detect_scheme(b2.vocab.tok2id),
                                     detect_scheme(vocab.tok2id)])
    p0 = gpt.init_params(torch.Generator().manual_seed(3), cfg)
    out["init/shapes"] = np.asarray(sorted(
        f"{k}:{tuple(v.shape)}:{str(v.dtype).replace('torch.', '')}"
        for k, v in flatten_out(p0, "").items()))
    p1 = gpt.init_params(torch.Generator().manual_seed(3), cfg)
    out["init/same_seed"] = np.asarray(all(
        np.array_equal(a, b) for a, b in zip(flatten_out(p0, "").values(),
                                             flatten_out(p1, "").values())))
    out["init/stats"] = np.asarray(
        [float(p0["tok_emb"].std()), float(p0["pos"].abs().max()),
         float(p0["layers"][0]["attn"]["in_w"].abs().max()),
         float(p0["head"]["w"].abs().max())])


def _cli_generate_checks(inp, out, tmp_dir):
    """`cli generate` in this process, and its refusals as subprocesses."""
    import os
    import subprocess

    from eamg_tpu_torch import cli

    ckpt = str(inp["cli/ckpt"])
    for name, extra in json.loads(str(inp["cli/runs"])).items():
        mid = os.path.join(tmp_dir, f"{name}.mid")
        wav = os.path.join(tmp_dir, f"{name}.wav")
        code = cli.main(["generate", "--device", "cpu", "--checkpoint", ckpt,
                         "--out", mid, "--wav", wav, *extra])
        out[f"cli/{name}/code"] = np.asarray(code)
        with open(mid, "rb") as f:
            out[f"cli/{name}/midi"] = np.frombuffer(f.read(), np.uint8)
        with open(wav, "rb") as f:
            out[f"cli/{name}/wav_head"] = np.frombuffer(f.read(12), np.uint8)
    for flag, values in json.loads(str(inp["cli/modes"])).items():
        mid = os.path.join(tmp_dir, f"mode{flag}.mid")
        r = subprocess.run(
            [sys.executable, "-m", "eamg_tpu_torch.cli", "generate",
             "--device", "cpu", "--checkpoint", ckpt, "--out", mid, flag,
             *values], capture_output=True, text=True, timeout=120)
        out[f"cli/{flag}/code"] = np.asarray(r.returncode)
        out[f"cli/{flag}/stderr"] = np.asarray(r.stderr[-500:])
        if os.path.isfile(mid):
            with open(mid, "rb") as f:
                out[f"cli/{flag}/midi"] = np.frombuffer(f.read(), np.uint8)


def _bench_checks(out):
    """The bench module's loop at a cut depth, length and batch, in this
    process; and the module itself, which wants a card."""
    import subprocess

    from eamg_tpu_torch import bench

    cfg = bench.large2_config(n_layer=1)
    params = bench.make_params(cfg, 0, "cpu")
    prompt = bench.bench_prompt("cpu", batch=4)
    out["bench/lines"] = np.asarray(json.dumps(
        [bench.bench_impl(params, cfg, prompt, 20, impl, runs=1)
         for impl in ("sp", "fold2")]))
    r = subprocess.run([sys.executable, "-m", "eamg_tpu_torch.bench"],
                       capture_output=True, text=True, timeout=120)
    out["bench/no_card_code"] = np.asarray(r.returncode)
    out["bench/no_card_stderr"] = np.asarray(r.stderr[-500:])


def task_batch(inp, out):
    import tempfile

    models = {}
    for tag in json.loads(str(inp["tags"])):
        models[tag] = _batch_model_checks(inp, out, tag)
    _sampling_checks(inp, out)
    _generator_checks(inp, out, *models["mha"])
    with tempfile.TemporaryDirectory() as tmp:
        _cli_generate_checks(inp, out, tmp)
    _bench_checks(out)


# ------------------------------------------------------------------- ragged

def flatten_out(tree, prefix):
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            flat[path] = np.asarray(node)

    walk(tree, prefix)
    return flat


def _np_cache(cache):
    return {"kv": [kv.numpy().copy() for kv in cache["kv"]],
            "lengths": cache["lengths"].numpy().copy()}


def _ragged_model_checks(inp, out, tag, params, cfg):
    from eamg_tpu_torch.decode import ragged
    from eamg_tpu_torch.utils.checkpoint import (ragged_cache_from_jax,
                                                 ragged_cache_to_jax)

    ids = _t(inp[f"{tag}/ids"]).long()
    lens = _t(inp[f"{tag}/lens"])
    cache = ragged.init_ragged_cache(cfg, ids.shape[0],
                                     int(inp[f"{tag}/max_len"]))
    logits, cache = ragged.prefill_ragged(params, ids, lens, cfg, cache)
    out[f"{tag}/prefill"] = logits.numpy()
    out.update(flatten_out(_np_cache(cache), f"{tag}/cache0"))
    last = ids[torch.arange(ids.shape[0]), (lens - 1).long()]
    steps = []
    for row in inp[f"{tag}/forced"]:
        lg, cache = ragged.decode_step_ragged(params, last, cache, cfg)
        steps.append(lg.numpy())
        last = _t(row).long()
    out[f"{tag}/decode"] = np.stack(steps)
    out.update(flatten_out(_np_cache(cache), f"{tag}/cache1"))
    for when in ("cache0", "cache1"):
        jc = ragged_cache_from_jax(unflatten(inp, f"{tag}/jax_{when}"))
        out.update(flatten_out(_np_cache(jc), f"{tag}/jax_{when}"))
    back = ragged_cache_to_jax(cache, cfg.kv_heads)
    out.update(flatten_out({"k": back["k"], "v": back["v"]},
                           f"{tag}/back1"))


def _ragged_prng_checks(inp, out):
    from eamg_tpu_torch.decode.ragged import draw_noise
    from eamg_tpu_torch.decode.sampling import sample_rows
    from eamg_tpu_torch.utils import prng

    keys = prng.key_rows([int(s) for s in inp["prng/seeds"]])
    out["prng/key_rows"] = keys
    out["prng/split_next"], out["prng/split_sub"] = prng.split_rows(keys)
    out["prng/chain_keys"], out["prng/chain_subs"] = prng.split_rows_chain(
        keys, 5)
    out["prng/fold_in"] = np.asarray(
        [prng.fold_in(prng.PRNGKey(9), i) for i in range(6)], np.uint32)
    V = inp["prng/logits"].shape[1]
    out["prng/bits"] = prng.bits(keys, (V,)).numpy().astype(np.uint32)
    logits, temps = _t(inp["prng/logits"]), _t(inp["prng/temps"])
    noise = draw_noise(keys, V, CPU)
    out["prng/sample_rows"] = sample_rows(logits, temps, 40,
                                          gumbel=noise).numpy()
    out["prng/sample_rows_top_p"] = sample_rows(
        logits, temps, 40, top_p=0.85, gumbel=noise).numpy()
    out["prng/sample_rows_per_row"] = sample_rows(
        logits, temps, 40, top_ps=_t(inp["prng/top_ps"]),
        min_ps=_t(inp["prng/min_ps"]), gumbel=noise).numpy()


def task_ragged(inp, out):
    from eamg_tpu_torch.decode.ragged import generate_kv_ragged
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    models = {}
    for tag in json.loads(str(inp["tags"])):
        cfg = _cfg(inp, f"{tag}/cfg")
        params = params_from_jax(unflatten(inp, f"{tag}/p"))
        models[tag] = (params, cfg)
        _ragged_model_checks(inp, out, tag, params, cfg)
    for name in json.loads(str(inp["gen_cases"])):
        spec = json.loads(str(inp[f"gen/{name}/spec"]))
        params, cfg = models[spec.pop("cfg")]
        keys = inp[f"gen/{name}/keys"]
        rngs = prng.PRNGKey(int(keys)) if keys.ndim == 0 \
            else prng.key_rows([int(s) for s in keys])
        prompt = _t(inp[f"gen/{name}/prompt"]).long()
        buf, n = generate_kv_ragged(
            params, prompt, inp[f"gen/{name}/lens"], rngs, cfg,
            spec.pop("max_len"), eos_id=spec.pop("eos"), **spec)
        out[f"gen/{name}/buf"] = buf.numpy()
        out[f"gen/{name}/lengths"] = n.numpy()
        out[f"gen/{name}/prompt_echo"] = prompt.numpy()
    _ragged_prng_checks(inp, out)


# ------------------------------------------------------------------- engine

WAIT = 300.0   # every wait below gives up after this many seconds


def _wait_until(cond, what):
    import time

    deadline = time.monotonic() + WAIT
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _threads(fn, args_list):
    import threading

    ts = [threading.Thread(target=fn, args=a, daemon=True)
          for a in args_list]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=WAIT)
        assert not t.is_alive(), "a request thread timed out"


def _engine_state_sequence(inp, out, gen, spec):
    from eamg_tpu_torch.serve.continuous import (admit_row, init_state,
                                                 ragged_chunk)
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import ragged_cache_from_jax

    state = init_state(gen.cfg, spec["slots"], spec["max_len"], device=CPU)
    common = dict(top_k=spec["top_k"], greedy=False, mask_value=-1e10,
                  eos_id=gen.eos_id, pad_id=gen.pad_id, top_p=1.0)
    for i, call in enumerate(spec["sequence"]):
        if call[0] == "admit":
            ids, seed, temp = spec["requests"][call[1]]
            prompt = torch.zeros((1, 16), dtype=torch.int64)
            prompt[0, :len(ids)] = torch.tensor(ids)
            state = admit_row(gen.params, state, prompt, len(ids), call[2],
                              prng.PRNGKey(seed), call[3], temp, gen.cfg,
                              **common)
        else:
            state = ragged_chunk(gen.params, state, gen.cfg,
                                 chunk=spec["chunk"], **common)
        for key in ("buf", "pos", "last", "done", "row_max"):
            out[f"seq/{i}/{key}"] = state[key].numpy().copy()
        out[f"seq/{i}/rngs"] = state["rngs"].copy()
        out[f"seq/{i}/lengths"] = state["cache"]["lengths"].numpy().copy()
        out.update(flatten_out(_np_cache(state["cache"]), f"seq/{i}/cache"))
        jc = ragged_cache_from_jax(unflatten(inp, f"seq/{i}/jax_cache"))
        out.update(flatten_out(_np_cache(jc), f"seq/{i}/jax_cache"))


def _submit_all(eng, requests, rows, prefix, out):
    import time

    def hit(i, req, extra):
        ids, seed, temp = req
        time.sleep(0.05 * i)                      # staggered admission
        rows[i] = eng.submit(ids, temperature=temp, seed=seed, timeout=WAIT,
                             **extra)

    _threads(hit, [(i, req, extra)
                   for i, (req, extra) in enumerate(requests)])
    for i, row in rows.items():
        out[f"{prefix}/{i}"] = np.asarray(row)


def task_engine(inp, out):
    import threading

    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.decode.ragged import generate_kv_ragged
    from eamg_tpu_torch.serve import continuous
    from eamg_tpu_torch.serve.batcher import RequestBatcher
    from eamg_tpu_torch.serve.continuous import (ContinuousBatcher,
                                                 EngineOverloaded)
    from eamg_tpu_torch.tokenizer import Vocab
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    spec = json.loads(str(inp["spec"]))
    eos = int(inp["eos"])
    gen = Generator(params_from_jax(unflatten(inp, "p")), _cfg(inp, "cfg"),
                    Vocab(json.loads(str(inp["vocab"]))),
                    eos_token=f"t{eos}", pad_token="t0", device=CPU)
    reqs = spec["requests"]
    geometry = dict(slots=spec["slots"], chunk=spec["chunk"],
                    max_len=spec["max_len"], top_k=spec["top_k"])
    _engine_state_sequence(inp, out, gen, spec)

    def solo(i, top_p=1.0, min_p=0.0):
        ids, seed, temp = reqs[i]
        prompt = torch.zeros((1, 16), dtype=torch.int64)
        prompt[0, :len(ids)] = torch.tensor(ids)
        buf, n = generate_kv_ragged(
            gen.params, prompt, [len(ids)], prng.key_rows([seed]), gen.cfg,
            spec["max_len"], temperature=temp, top_k=spec["top_k"],
            eos_id=eos, pad_id=gen.pad_id, top_p=top_p, min_p=min_p)
        return buf[0, :int(n[0])].numpy()

    for i in range(len(reqs)):
        out[f"solo/{i}"] = solo(i)

    # engine rows, then the same requests detached on the same engine
    eng = ContinuousBatcher(gen, **geometry)
    try:
        _submit_all(eng, [(r, {}) for r in reqs], {}, "engine", out)
        stats = dict(eng.stats)
        stats["join_delay_ms"] = list(stats["join_delay_ms"])
        out["engine_stats"] = np.asarray(json.dumps(stats))
        calls = {"n": 0}
        real_chunk = continuous.ragged_chunk

        def counting_chunk(*a, **k):
            calls["n"] += 1
            return real_chunk(*a, **k)

        continuous.ragged_chunk = counting_chunk
        try:
            for i, (ids, seed, temp) in enumerate(reqs):
                calls["n"] = 0
                out[f"detached/{i}"] = np.asarray(eng.run_detached(
                    ids, temperature=temp, seed=seed))
                if i == spec["early"]:
                    out["detached_chunks_early"] = np.asarray(calls["n"])
            # the same budget with a stream that does not end early
            calls["n"] = 0
            eng.run_detached(reqs[spec["early"]][0], seed=reqs[2][1])
            out["detached_chunks_full"] = np.asarray(calls["n"])
        finally:
            continuous.ragged_chunk = real_chunk
    finally:
        eng.close()

    # per-row sampling mode
    eng = ContinuousBatcher(gen, per_row_sampling=True, **geometry)
    try:
        rr = spec["row_requests"]
        _submit_all(eng, [(reqs[i], {"top_p": tp, "min_p": mp})
                          for i, tp, mp in rr], {}, "row_engine", out)
        for j, (i, tp, mp) in enumerate(rr):
            ids, seed, temp = reqs[i]
            out[f"row_detached/{j}"] = np.asarray(eng.run_detached(
                ids, temperature=temp, seed=seed, top_p=tp, min_p=mp))
    finally:
        eng.close()

    # a full queue sheds load: one slot, one place in the queue. The
    # worker is held inside its first chunk, so the queue cannot drain
    # while the third request arrives.
    eng = ContinuousBatcher(gen, slots=1, chunk=spec["chunk"],
                            max_len=spec["max_len"], top_k=spec["top_k"],
                            max_queue=1)
    real_chunk = continuous.ragged_chunk
    gate = threading.Event()

    def held_chunk(*a, **k):
        assert gate.wait(WAIT), "the gate was never opened"
        return real_chunk(*a, **k)

    try:
        done = {}

        def hit(name, i):
            ids, seed, temp = reqs[i]
            done[name] = eng.submit(ids, temperature=temp, seed=seed,
                                    timeout=WAIT)

        continuous.ragged_chunk = held_chunk
        a = threading.Thread(target=hit, args=("a", 2), daemon=True)
        a.start()
        _wait_until(lambda: eng.stats["admitted"] == 1, "the first admission")
        b = threading.Thread(target=hit, args=("b", 3), daemon=True)
        b.start()
        _wait_until(lambda: eng._q.qsize() == 1,
                    "the second request to queue")
        try:
            eng.submit(reqs[0][0], seed=1, timeout=WAIT)
            out["overload/raised"] = np.asarray("none")
        except EngineOverloaded:
            out["overload/raised"] = np.asarray("EngineOverloaded")
        continuous.ragged_chunk = real_chunk
        gate.set()
        a.join(timeout=WAIT)
        b.join(timeout=WAIT)
        out["overload/rejected"] = np.asarray(eng.stats["rejected"])
        out["overload/others_served"] = np.asarray(
            done["a"] == out["engine/2"].tolist()
            and done["b"] == out["engine/3"].tolist())

        # a request nobody waits for any more is cancelled, its slot freed
        try:
            eng.submit(reqs[2][0], seed=5, timeout=0.0)
            out["cancel/raised"] = np.asarray("none")
        except TimeoutError:
            out["cancel/raised"] = np.asarray("TimeoutError")
        _wait_until(lambda: eng.stats["cancelled"] == 1 and eng.idle(),
                    "the cancelled row's slot")
        out["cancel/cancelled"] = np.asarray(eng.stats["cancelled"])
        out["cancel/free_slots"] = np.asarray(len(eng._free))
        ids, seed, temp = reqs[1]
        out["cancel/next"] = np.asarray(eng.submit(
            ids, temperature=temp, seed=seed, timeout=WAIT))
    finally:
        continuous.ragged_chunk = real_chunk
        gate.set()
        eng.close()

    # an error inside a chunk reaches the client and the engine serves on
    eng = ContinuousBatcher(gen, **geometry)
    real_chunk = continuous.ragged_chunk

    def broken_chunk(*a, **k):
        continuous.ragged_chunk = real_chunk
        raise RuntimeError("injected chunk failure")

    try:
        continuous.ragged_chunk = broken_chunk
        try:
            eng.submit(reqs[0][0], seed=1, timeout=WAIT)
            out["fail/error"] = np.asarray("none")
        except RuntimeError as e:
            out["fail/error"] = np.asarray(str(e))
        _wait_until(eng.idle, "the engine to settle")
        out["fail/free_slots"] = np.asarray(len(eng._free))
        ids, seed, temp = reqs[3]
        out["fail/next"] = np.asarray(eng.submit(
            ids, temperature=temp, seed=seed, timeout=WAIT))
    finally:
        continuous.ragged_chunk = real_chunk
        eng.close()

    # the window batcher: a wide window, so the requests share decodes
    bat = RequestBatcher(gen, max_batch=3, window_ms=1000.0,
                         max_len=spec["max_len"])
    try:
        rows = {}

        def hit_w(i):
            ids, seed, temp = reqs[i]
            rows[i] = bat.submit(ids, temperature=1.0, top_k=spec["top_k"],
                                 seed=seed, timeout=WAIT)

        # the window batcher groups by temperature; the JAX rows to match
        # were drawn at each request's own temperature, so send those with
        # temperature 1.0 together and the others on their own
        same = [i for i, r in enumerate(reqs) if r[2] == 1.0]
        _threads(hit_w, [(i,) for i in same])
        for i, (ids, seed, temp) in enumerate(reqs):
            if i not in same:
                rows[i] = bat.submit(ids, temperature=temp,
                                     top_k=spec["top_k"], seed=seed,
                                     timeout=WAIT)
        for i, row in rows.items():
            out[f"window/{i}"] = np.asarray(row)
        out["window_stats"] = np.asarray(json.dumps(bat.stats))
    finally:
        bat.close()
    _engine_option_checks(inp, out, gen, spec)


def _opt_kw(spec, name):
    kw = dict(spec["opts"][name])
    if "penalties" in kw:
        kw["penalties"] = tuple(kw["penalties"])
    return kw


def _engine_option_checks(inp, out, gen, spec):
    """An engine with per-row sampling, an n-gram ban and a grammar: its
    state after each call of a sequence, its rows, a plain row detached;
    the window batcher with the same options."""
    from eamg_tpu_torch.decode.grammar import grammar_a
    from eamg_tpu_torch.serve.batcher import RequestBatcher
    from eamg_tpu_torch.serve.continuous import (ContinuousBatcher,
                                                 admit_row, init_state,
                                                 ragged_chunk)
    from eamg_tpu_torch.tokenizer import Vocab
    from eamg_tpu_torch.utils import prng

    gram = grammar_a(Vocab(json.loads(str(inp["names"]))))
    reqs, ngram = spec["requests"], spec["ngram"]
    state = init_state(gen.cfg, spec["slots"], spec["max_len"], device=CPU,
                       per_row_sampling=True, no_repeat_ngram=ngram,
                       grammar=True)
    common = dict(top_k=spec["top_k"], greedy=False, mask_value=-1e10,
                  eos_id=gen.eos_id, pad_id=gen.pad_id, top_p=1.0,
                  per_row_sampling=True, no_repeat_ngram=ngram,
                  grammar=gram.arrays(CPU))
    for i, call in enumerate(spec["opt_sequence"]):
        if call[0] == "admit":
            ids, seed, temp = reqs[call[1]]
            kw = _opt_kw(spec, call[4])
            prompt = torch.zeros((1, 16), dtype=torch.int64)
            prompt[0, :len(ids)] = torch.tensor(ids)
            state = admit_row(
                gen.params, state, prompt, len(ids), call[2],
                prng.PRNGKey(seed), call[3], temp, gen.cfg,
                row_top_p=kw.get("top_p", 1.0),
                row_penalties=kw.get("penalties", (1.0, 0.0, 0.0)),
                row_ngram_on=bool(kw.get("no_repeat_ngram")),
                row_gram_on=bool(kw.get("grammar")), **common)
        else:
            state = ragged_chunk(gen.params, state, gen.cfg,
                                 chunk=spec["chunk"], **common)
        for key in ("buf", "pos", "last", "done", "row_max", "counts",
                    "rep_ps", "freq_ps", "pres_ps", "ngram_on", "gstate",
                    "gram_on"):
            out[f"opt_seq/{i}/{key}"] = state[key].numpy().copy()
        out[f"opt_seq/{i}/rngs"] = state["rngs"].copy()
        out[f"opt_seq/{i}/lengths"] = \
            state["cache"]["lengths"].numpy().copy()

    rows = spec["opt_rows"]
    eng = ContinuousBatcher(gen, slots=spec["slots"], chunk=spec["chunk"],
                            max_len=spec["max_len"], top_k=spec["top_k"],
                            per_row_sampling=True, no_repeat_ngram=ngram,
                            grammar=gram)
    try:
        _submit_all(eng, [(reqs[i], _opt_kw(spec, name))
                          for i, name in rows], {}, "opt_engine", out)
        ids, seed, temp = reqs[rows[0][0]]
        out["opt_detached/0"] = np.asarray(eng.run_detached(
            ids, temperature=temp, seed=seed))
    finally:
        eng.close()

    bat = RequestBatcher(gen, max_batch=len(spec["window_rows"]),
                         window_ms=1000.0, max_len=spec["max_len"],
                         grammar=gram)
    try:
        got = {}

        def hit(j):
            i, name = rows[j]
            ids, seed, temp = reqs[i]
            got[j] = bat.submit(ids, temperature=temp, top_k=spec["top_k"],
                                seed=seed, timeout=WAIT,
                                **_opt_kw(spec, name))

        _threads(hit, [(j,) for j in spec["window_rows"]])
        for j, row in got.items():
            out[f"opt_window/{j}"] = np.asarray(row)
        out["opt_window_stats"] = np.asarray(json.dumps(bat.stats))
    finally:
        bat.close()


# ------------------------------------------------------------------- graphs

def _graph_bookkeeping(out):
    """BlockGraph's launch counts with CUDA's stream and graph calls stood
    in for (tests/test_torch_graphs.py): a block that calls two fake
    wrappers and, from another thread, a third."""
    import threading
    from unittest import mock

    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.ops import _build

    seen = {}

    class Stream:
        def wait_stream(self, other):
            pass

    class Graph:
        def replay(self):
            pass

    class Capture:
        def __init__(self, graph, stream=None, capture_error_mode=None):
            seen["mode"] = capture_error_mode

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def block():
        _build.count_launch("k_a")
        _build.count_launch("k_a")
        _build.count_launch("k_b")
        other = threading.Thread(target=_build.count_launch, args=("other",))
        other.start()
        other.join()

    _build.reset_launch_counts()
    try:
        with mock.patch.object(torch.cuda, "current_stream",
                               lambda *a: Stream()), \
                mock.patch.object(torch.cuda, "Stream", lambda *a: Stream()), \
                mock.patch.object(torch.cuda, "stream",
                                  lambda s: Capture(None)), \
                mock.patch.object(torch.cuda, "CUDAGraph", Graph), \
                mock.patch.object(torch.cuda, "graph", Capture):
            g = graphs.BlockGraph(block, "cuda")
            for _ in range(4):
                g.run()
        out["book/block_launches"] = np.asarray(json.dumps(g.launches))
        out["book/counts"] = np.asarray(json.dumps(_build.launch_counts()))
        out["book/replays"] = np.asarray(g.replays)
        out["book/mode"] = np.asarray(seen["mode"])
        _build.reset_launch_counts()
        g = graphs.BlockGraph(block, "cpu")
        for _ in range(3):
            g.run()
        out["book/cpu_counts"] = np.asarray(json.dumps(
            _build.launch_counts()))
        out["book/cpu_graph"] = np.asarray(str(g.graph))
    finally:
        _build.reset_launch_counts()


def task_graphs(inp, out):
    """tests/test_torch_graphs.py: generate_kv and generate_kv_ragged on
    their block runners (eager on the CPU), requests again on the cached
    states, the state keys, decode_step with the device length, and the
    runner's launch bookkeeping."""
    from eamg_tpu_torch.decode import graphs
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.decode.ragged import generate_kv_ragged
    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    cfg = _cfg(inp, "cfg")
    params = params_from_jax(unflatten(inp, "p"))
    plen, max_len = int(inp["plen"]), int(inp["max_len"])

    def solo(spec, **extra):
        kw = dict(spec["kw"], **extra)
        if "penalties" in kw:
            kw["penalties"] = tuple(kw["penalties"])
        return generate_kv(params, _t(np.asarray(spec["prompt"])).long(),
                           plen, prng.PRNGKey(spec["seed"]), cfg, max_len,
                           attn_impl=spec["impl"], **kw)

    cases = json.loads(str(inp["cases"]))
    for name, spec in cases.items():
        buf, n = solo(spec)
        out[f"solo/{name}/n"] = np.asarray(n)
        out[f"solo/{name}/buf"] = buf[:, :n].numpy()
        out[f"solo/{name}/tail"] = buf[:, n:].numpy()

    rg = json.loads(str(inp["ragged"]))

    def ragged(spec):
        return generate_kv_ragged(
            params, _t(np.asarray(rg["prompt"])).long(), rg["lens"],
            prng.key_rows(rg["seeds"]), cfg, rg["max_len"],
            top_k=rg["top_k"], greedy=spec["greedy"],
            eos_id=spec["eos_id"])

    for name, spec in rg["cases"].items():
        buf, n = ragged(spec)
        out[f"ragged/{name}/buf"] = buf.numpy()
        out[f"ragged/{name}/n"] = n.numpy()

    # a second request on a cached state, after other requests used it
    for name in ("sampled/block_first/sp", "greedy/B3"):
        buf, n = solo(cases[name])
        out[f"again/{name}/buf"] = buf[:, :n].numpy()
    out["again/ragged/buf"] = ragged(rg["cases"]["sampled/block_last"])[
        0].numpy()

    # the states' keys: values a request fills in share one state
    spec = cases["sampled/no_eos"]
    before = len(graphs._states)
    solo(spec, temperature=0.7)
    generate_kv(params, _t(np.asarray(spec["prompt"])).long(), plen - 1,
                prng.PRNGKey(99), cfg, max_len, attn_impl="sp",
                **spec["kw"])
    solo(cases["sampled/top_p"], top_p=0.6)
    out["keys/same"] = np.asarray(len(graphs._states) - before)
    solo(spec, top_p=0.6)
    out["keys/top_p_on"] = np.asarray(len(graphs._states) - before)

    # decode_step over a device length, both cache layouts
    prompt = _t(inp["tf/prompt"]).long()
    for impl in ("sp", "fold_sp"):
        cache = gpt.init_kv_cache(cfg, 2, 40,
                                  layout=gpt.cache_layout(impl, cfg))
        length = cache["length"]
        _, cache = gpt.prefill(params, prompt, cfg, cache, prompt_len=plen)
        last, logits = prompt[:, plen - 1:plen], []
        for row in inp["tf/forced"]:
            lg, cache = gpt.decode_step(params, last, cache, cfg, impl)
            logits.append(lg.numpy())
            last = _t(row).long()[:, None]
        out[f"tf/{impl}/logits"] = np.stack(logits)
        same = cache["length"] is length
        out[f"tf/{impl}/length"] = np.asarray(
            f"{str(length.dtype).split('.')[-1]} {list(length.shape)} "
            + ("in place" if same else "replaced"))
        out[f"tf/{impl}/length_value"] = np.asarray(int(length[0]))

    _graph_bookkeeping(out)


# --------------------------------------------------------------------- bf16

def task_bf16(inp, out):
    """_mlp in bf16 and f32 under each ``kernels`` setting, and the
    flagship's bf16 teacher-forced logits (tests/test_torch_bf16.py)."""
    import dataclasses

    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_A
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    for act in inp["acts"]:
        for dt, bf in (("bf16", True), ("f32", False)):
            a = unflatten(inp, f"mlp/{act}/{dt}")
            p = {k: _t(a[k], bf) for k in ("w1", "b1", "w2", "b2")}
            for kernels in ("xla", "pallas"):
                cfg = _cfg(inp, f"mlp/{act}/cfg/{kernels}")
                if not bf:
                    cfg = dataclasses.replace(cfg, dtype="float32")
                out[f"mlp/{act}/{dt}/{kernels}"] = _np(
                    gpt._mlp(p, _t(a["x"], bf), cfg))
    ck = load_checkpoint(DEMO_CKPT_A)
    cfg = ck["cfg"]
    ids = _t(inp["tf/ids"]).long()
    cache = gpt.init_kv_cache(cfg, 1, ids.shape[1] + len(inp["tf/forced"]))
    logits, cache = gpt.prefill(ck["params"], ids, cfg, cache,
                                prompt_len=ids.shape[1])
    steps = [logits[0]]
    last = ids[:, -1:]
    for tok in inp["tf/forced"]:
        lg, cache = gpt.decode_step(ck["params"], last, cache, cfg)
        steps.append(lg)
        last = torch.full_like(last, int(tok))
    out["tf"] = torch.cat(steps).float().numpy()

# ------------------------------------------------------------------- stream

def _engine_stream_checks(inp, out, params, cfg):
    """submit_stream's deltas beside submit() on one engine, three rows at
    once; a stream closed after its first delta, on an engine whose rows
    never end early (no EOS in its vocabulary)."""
    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.serve.continuous import ContinuousBatcher
    from eamg_tpu_torch.tokenizer import Vocab

    spec = json.loads(str(inp["engine"]))
    reqs = json.loads(str(inp["engine_reqs"]))
    max_len = int(inp["max_len"])
    names = {i: f"t{i}" for i in range(cfg.vocab_size)}
    names[0], names[int(inp["eos"])] = "[PAD]", "[END_SEQUENCE]"
    gen = Generator(params, cfg, Vocab({t: i for i, t in names.items()}),
                    device=CPU)
    eng = ContinuousBatcher(gen, max_len=max_len, **spec)
    deltas = {}
    try:
        def hit(i):
            ids, seed, temp = reqs[i]
            deltas[i] = list(eng.submit_stream(ids, temperature=temp,
                                               seed=seed, timeout=WAIT))

        _threads(hit, [(i,) for i in range(len(reqs))])
        for i, (ids, seed, temp) in enumerate(reqs):
            out[f"engine/{i}/deltas"] = np.asarray(
                [t for d in deltas[i] for t in d], np.int64)
            out[f"engine/{i}/n_deltas"] = np.asarray(len(deltas[i]))
            out[f"engine/{i}/submit"] = np.asarray(eng.submit(
                ids, temperature=temp, seed=seed, timeout=WAIT), np.int64)
    finally:
        eng.close()
    gen = Generator(params, cfg, Vocab({f"t{i}": i
                                        for i in range(cfg.vocab_size)}),
                    device=CPU)
    eng = ContinuousBatcher(gen, max_len=max_len, **spec)
    try:
        stream = eng.submit_stream(reqs[0][0], seed=1, timeout=WAIT)
        out["cancel/first_delta"] = np.asarray(len(next(stream)))
        stream.close()
        _wait_until(lambda: eng.stats["cancelled"] == 1 and not eng._live,
                    "the closed stream's slot")
        out["cancel/cancelled"] = np.asarray(eng.stats["cancelled"])
        out["cancel/served"] = np.asarray(eng.stats["served"])
        out["cancel/free"] = np.asarray(len(eng._free))
        out["cancel/after"] = np.asarray(len(eng.submit(
            reqs[1][0], seed=2, timeout=WAIT)))
    finally:
        eng.close()


def _stream_pipeline(inp, tag):
    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.emotion import EmotionClassifier
    from eamg_tpu_torch.serve import Pipeline
    from eamg_tpu_torch.tokenizer import SchemeB3, Vocab
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    cfg = _cfg(inp, f"{tag}/cfg")
    vocab = Vocab(json.loads(str(inp[f"{tag}/vocab"])))
    params = params_from_jax(unflatten(inp, f"{tag}/p"))
    clf = EmotionClassifier(device=CPU)
    if tag == "b3":
        gen = Generator(params, cfg, vocab, eos_token="[END_SEQ]",
                        device=CPU)
        return Pipeline(gen, clf, scheme="b3",
                        scheme_b=SchemeB3(seq_len=cfg.seq_len))
    gen = Generator(params, cfg, vocab, device=CPU)
    if tag == "co":
        return Pipeline(gen, clf, coalesce="continuous",
                        coalesce_opts=json.loads(str(inp["co/engine"])),
                        medusa_heads=_heads_from(inp, "co/heads"))
    return Pipeline(gen, clf)


def _sse_checks(inp, out):
    """The calls of test_torch_stream.py against an in-process server of
    each pipeline; the contract's calls against the solo Scheme-A one."""
    from eamg_tpu_torch.serve import (make_server, serve_forever_in_thread,
                                      shutdown_gracefully)

    calls = json.loads(str(inp["calls"]))
    contract = json.loads(str(inp["contract"]))
    server_of = json.loads(str(inp["contract_server"]))
    for tag in ("a", "co", "b3"):
        pipe = _stream_pipeline(inp, tag)
        port = _free_port()
        server = make_server(pipe, "127.0.0.1", port)
        thread = serve_forever_in_thread(server)
        todo = [(f"http/{tag}/{k}", v) for k, v in calls.items()]
        todo += [(f"contract/{k}", v) for k, v in contract.items()
                 if server_of.get(k, "a") == tag]
        try:
            for key, (query, fields) in todo:
                status, body, headers = _post_form(port, fields, query)
                out[f"{key}/status"] = np.asarray(status)
                out[f"{key}/type"] = np.asarray(
                    headers.get("Content-Type", ""))
                out[f"{key}/body"] = np.frombuffer(body, np.uint8)
        finally:
            server.shutdown()
            shutdown_gracefully(server, pipe)
            thread.join(timeout=30)


def task_stream(inp, out):
    """tests/test_torch_stream.py: the chunked stream, C2's uncached loop,
    the engine's streams and the SSE server."""
    import threading

    from eamg_tpu_torch.decode.loop import generate_full, generate_kv
    from eamg_tpu_torch.decode.stream import stream_tokens
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    cfg = _cfg(inp, "model/cfg")
    params = params_from_jax(unflatten(inp, "model/p"))
    max_len = int(inp["max_len"])
    streams = json.loads(str(inp["streams"]))
    for name, kw in streams.items():
        kw = dict(kw)
        prompt = kw.pop("prompt")
        if "penalties" in kw:
            kw["penalties"] = tuple(kw["penalties"])
        out[f"stream/{name}"] = np.asarray(list(stream_tokens(
            params, cfg, prompt, max_len, **kw)), np.int64)
    # two streams of one graph key at once: the first held after its first
    # token while the second runs to its end in another thread
    held_name, other_name = json.loads(str(inp["stalled"]))

    def start(name):
        kw = dict(streams[name])
        return stream_tokens(params, cfg, kw.pop("prompt"), max_len, **kw)

    held = start(held_name)
    first = [next(held)]
    other = {}
    thread = threading.Thread(
        target=lambda: other.update(toks=list(start(other_name))),
        daemon=True)
    thread.start()
    thread.join(timeout=WAIT)
    out["stalled/other_ended"] = np.asarray(not thread.is_alive())
    out["stalled/other"] = np.asarray(other.get("toks", []), np.int64)
    out["stalled/held"] = np.asarray(first + list(held), np.int64)
    ids = [int(i) for i in inp["prompt"]]
    p = len(ids)
    prompt = torch.zeros((1, 16), dtype=torch.int64)
    prompt[0, :p] = torch.tensor(ids)
    buf, n = generate_kv(params, prompt, p, prng.PRNGKey(0), cfg, max_len,
                         greedy=True, refeed_last_prompt=False)
    out["kv_greedy"] = buf[0, p:n].numpy()
    full = json.loads(str(inp["full"]))
    full["penalties"] = tuple(full["penalties"])
    for seed in inp["full_seeds"]:
        buf, n = generate_full(params, prompt, p, prng.PRNGKey(int(seed)),
                               cfg, max_len, eos_id=int(inp["eos"]), **full)
        out[f"full/{int(seed)}"] = buf[0, :n].numpy()
    _engine_stream_checks(inp, out, params, cfg)
    _sse_checks(inp, out)


# ----------------------------------------------------------------------- b3

def _b3_serve_checks(out):
    """pipeline_from_checkpoint on demo_ckpt_b3 (bf16, as shipped) behind
    the server: WAV and MIDI."""
    from eamg_tpu_torch.emotion import EmotionClassifier
    from eamg_tpu_torch.serve import (make_server, pipeline_from_checkpoint,
                                      serve_forever_in_thread,
                                      shutdown_gracefully)
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_B3

    pipe = pipeline_from_checkpoint(
        DEMO_CKPT_B3, device=CPU, coalesce="continuous",
        classifier=EmotionClassifier(backend="lexicon", device=CPU))
    gen = pipe.generator
    out["serve/info"] = np.asarray(json.dumps({
        "scheme": pipe.scheme, "eos": gen.vocab.id2tok[gen.eos_id],
        "batcher": pipe.batcher, "max_len": gen.max_supported_len()}))
    port = _free_port()
    server = make_server(pipe, "127.0.0.1", port)
    thread = serve_forever_in_thread(server)
    try:
        for fmt in ("wav", "midi"):
            status, body, headers = _post_form(
                port, {"prompt": "so happy", "seed": 3}, f"?format={fmt}")
            out[f"serve/{fmt}/status"] = np.asarray(status)
            out[f"serve/{fmt}/body"] = np.frombuffer(body, np.uint8)
            out[f"serve/{fmt}/tokens"] = np.asarray(
                int(headers.get("X-EAMG-Tokens", 0)))
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)


def _b3_cli_checks(inp, out, tmp):
    import contextlib
    import os

    from eamg_tpu_torch import cli
    from eamg_tpu_torch.serve import pipeline_from_checkpoint
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_B3

    mid, wav = os.path.join(tmp, "b3.mid"), os.path.join(tmp, "b3.wav")
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out["cli/code"] = np.asarray(cli.main([
            "generate", "--device", "cpu", "--checkpoint", DEMO_CKPT_B3,
            "--max-len", "40", "--seed", "3", "--bpm", "96", "--key",
            "D minor", "--out", mid, "--wav", wav]))
    out["cli/stdout"] = np.asarray(log.getvalue())
    for key, path in (("cli/midi", mid), ("cli/wav", wav)):
        with open(path, "rb") as f:
            out[key] = np.frombuffer(f.read(), np.uint8)
    b2 = str(inp["b2/ckpt"])
    out["b2/pipeline"] = _raised(
        lambda: pipeline_from_checkpoint(b2, device=CPU))
    with contextlib.redirect_stderr(io.StringIO()):
        out["b2/cli_code"] = np.asarray(cli.main([
            "generate", "--device", "cpu", "--checkpoint", b2, "--out",
            mid]))


def task_b3(inp, out):
    """tests/test_torch_b3.py: demo_ckpt_b3 against JAX, the B3 pipeline,
    its server and CLI, and rows 7, 9 and 10's plain versions at Dh 48."""
    import dataclasses
    import tempfile

    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.ops import decode_fold
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_B3
    from eamg_tpu_torch.tokenizer import SchemeB3, Vocab
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    ck = load_checkpoint(DEMO_CKPT_B3)
    shapes, flat = [], [("", ck["params"])]
    while flat:
        path, node = flat.pop()
        if isinstance(node, dict):
            flat.extend((f"{path}/{k}", v) for k, v in node.items())
        elif isinstance(node, list):
            flat.extend((f"{path}/{i}", v) for i, v in enumerate(node))
        else:
            shapes.append(f"{path}:{tuple(node.shape)}:"
                          f"{str(node.dtype).replace('torch.', '')}")
    out["shapes"] = np.asarray(sorted(shapes))
    cfg = ck["cfg"]
    ids = _t(inp["tf/ids"]).long()
    cfg32 = dataclasses.replace(cfg, dtype="float32")

    def f32(node):
        if isinstance(node, dict):
            return {k: f32(v) for k, v in node.items()}
        if isinstance(node, list):
            return [f32(v) for v in node]
        return node.float()

    p32 = f32(ck["params"])
    out["logits"] = gpt.forward(p32, ids, cfg32).numpy()
    cache = gpt.init_kv_cache(cfg, 1, ids.shape[1] + len(inp["tf/forced"]))
    logits, cache = gpt.prefill(ck["params"], ids, cfg, cache,
                                prompt_len=ids.shape[1])
    steps, last = [logits[0]], ids[:, -1:]
    for tok in inp["tf/forced"]:
        lg, cache = gpt.decode_step(ck["params"], last, cache, cfg)
        steps.append(lg)
        last = torch.full_like(last, int(tok))
    out["tf"] = torch.cat(steps).float().numpy()
    b3 = SchemeB3(seq_len=cfg.seq_len)
    gen = Generator(p32, cfg32, Vocab(ck["vocab"]), eos_token="[END_SEQ]",
                    device=CPU)
    for i, (bpm, key, seed) in enumerate(json.loads(str(inp["gen/cases"]))):
        out[f"gen/{i}"] = gen.generate_ids(
            b3.control_prefix(bpm, key), max_len=int(inp["gen/max_len"]),
            seed=seed)[0]
    pipe = _stream_pipeline(inp, "b3")
    for i, (text, seed) in enumerate(json.loads(str(inp["pipe/requests"]))):
        r = pipe.generate(text, seed=seed, render_audio=False)
        out[f"pipe/{i}/midi"] = np.frombuffer(r.midi_bytes, np.uint8)
        out[f"pipe/{i}/tokens"] = np.asarray(r.tokens)
    out["sections/midi"] = np.frombuffer(pipe.generate_sections(
        str(inp["pipe/text3"]), seed=int(inp["pipe/sections_seed"]),
        render_audio=False).midi_bytes, np.uint8)
    _b3_serve_checks(out)
    with tempfile.TemporaryDirectory() as tmp:
        _b3_cli_checks(inp, out, tmp)
    q, kv, H = _t(inp["fold/q"]), _t(inp["fold/kv"]), int(inp["fold/H"])
    for key in inp.files:
        if key.startswith("fold/t/"):
            tname = key[len("fold/t/"):]
            t = _t(inp[key]) if inp[key].ndim else int(inp[key])
            for name in ("flash_decode_fold", "flash_decode_fold2",
                         "flash_decode_fold3"):
                out[f"fold/{name}/{tname}"] = getattr(decode_fold, name)(
                    q, kv, t, H).numpy()


# ------------------------------------------------------- medusa and spec


def _heads_from(inp, prefix):
    heads = unflatten(inp, prefix)
    return {"blocks": [{k: _t(v) for k, v in b.items()}
                       for b in heads["blocks"]]}


def _spec_pipeline(inp, tag, heads=True):
    """The demo pipeline ``tag`` ("a": Scheme A, causal; "b3") of the
    test's weights, with its Medusa heads unless ``heads`` is False."""
    from eamg_tpu_torch.decode import Generator
    from eamg_tpu_torch.emotion import EmotionClassifier
    from eamg_tpu_torch.serve import Pipeline
    from eamg_tpu_torch.tokenizer import SchemeB3, Vocab
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    cfg = _cfg(inp, f"{tag}/cfg")
    vocab = Vocab(json.loads(str(inp[f"{tag}/vocab"])))
    params = params_from_jax(unflatten(inp, f"{tag}/p"))
    clf = EmotionClassifier(device=CPU)
    hd = _heads_from(inp, f"{tag}/heads") if heads else None
    if tag == "b3":
        gen = Generator(params, cfg, vocab, eos_token="[END_SEQ]",
                        device=CPU)
        return Pipeline(gen, clf, scheme="b3", medusa_heads=hd,
                        scheme_b=SchemeB3(seq_len=cfg.seq_len))
    return Pipeline(Generator(params, cfg, vocab, device=CPU), clf,
                    medusa_heads=hd)


def _http_calls(pipe, calls: dict, out, prefix: str):
    """POST each of ``calls`` (name -> (query, fields)) to an in-process
    server of ``pipe``; GET /stats. Status, Content-Type and body under
    ``prefix/name``."""
    import urllib.request

    from eamg_tpu_torch.serve import (make_server, serve_forever_in_thread,
                                      shutdown_gracefully)

    port = _free_port()
    server = make_server(pipe, "127.0.0.1", port)
    thread = serve_forever_in_thread(server)
    try:
        for name, (query, fields) in calls.items():
            status, body, headers = _post_form(port, fields, query)
            out[f"{prefix}/{name}/status"] = np.asarray(status)
            out[f"{prefix}/{name}/type"] = np.asarray(
                headers.get("Content-Type", ""))
            out[f"{prefix}/{name}/body"] = np.frombuffer(body, np.uint8)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                    timeout=60) as r:
            out[f"{prefix}/stats"] = np.frombuffer(r.read(), np.uint8)
    finally:
        server.shutdown()
        shutdown_gracefully(server, pipe)
        thread.join(timeout=30)


def _medusa_http(inp, out):
    text, seed = "I finally got the job, I am so happy!", 5
    pipe = _spec_pipeline(inp, "b3")
    pipe.medusa_probe = {"tok_per_verify_est": 1.5, "likely_win": True}
    base = {"prompt": text, "seed": seed}
    got = {}
    _http_calls(pipe, {
        "oneshot": ("?format=midi", {**base, "medusa": "1"}),
        "stream": ("?stream=1&format=midi", {**base, "medusa": "1"}),
        "stream_penalty": ("?stream=1", {**base, "medusa": "1",
                                         "repetition_penalty": "1.3"}),
        "lookup_stream": ("?stream=1", {**base, "lookup": "1"}),
        "beams_stream": ("?stream=1", {**base, "beams": "2"}),
        "lookup_and_medusa": ("", {**base, "lookup": "1", "medusa": "1"}),
        "beams_too_many": ("", {**base, "beams": "17"}),
        "beams_and_penalty": ("", {**base, "beams": "2",
                                   "repetition_penalty": "1.3"}),
        "grammar": ("", {**base, "medusa": "1", "grammar": "1"}),
    }, got, "x")
    for name in ("oneshot", "stream"):
        out[f"http/{name}/status"] = got[f"x/{name}/status"]
        out[f"http/{name}/body"] = got[f"x/{name}/body"]
    out["http/stats"] = got["x/stats"]
    for k, v in got.items():
        name = k.split("/")[1]
        if name not in ("oneshot", "stream", "stats"):
            out[f"contract/{k[2:]}"] = v
    bare = _spec_pipeline(inp, "a", heads=False)
    _http_calls(bare, {
        "no_heads": ("", {**base, "medusa": "1"}),
        "no_heads_stream": ("?stream=1", {**base, "medusa": "1"})},
        out, "contract")
    out["http/stats_none"] = out.pop("contract/stats")


def _heads_mismatch(inp, out, tmp):
    """pipeline_from_checkpoint on demo_ckpt_b3's files beside a heads file
    of another width: medusa unavailable, with the reason."""
    import contextlib
    import os
    import pickle

    from eamg_tpu_torch.emotion import EmotionClassifier
    from eamg_tpu_torch.serve import pipeline_from_checkpoint

    src = str(inp["demo/b3"])
    for f in os.listdir(src):
        if f != "medusa_heads.pkl":
            os.symlink(os.path.join(src, f), os.path.join(tmp, f))
    with open(os.path.join(tmp, "medusa_heads.pkl"), "wb") as f:
        pickle.dump({"blocks": [{"w": np.zeros((16, 16), np.float32),
                                 "b": np.zeros(16, np.float32)}]}, f)
    with contextlib.redirect_stdout(io.StringIO()):
        pipe = pipeline_from_checkpoint(
            tmp, device=CPU,
            classifier=EmotionClassifier(backend="lexicon", device=CPU))
    out["mismatch/unavailable"] = np.asarray(str(pipe.medusa_unavailable))
    out["mismatch/heads"] = np.asarray(str(pipe.medusa_heads))


def task_medusa(inp, out):
    """tests/test_torch_medusa.py: decode_block, the heads, generate_medusa
    and its stream, the heads files and probe, the pipeline and HTTP."""
    import tempfile

    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.decode.medusa import (generate_medusa, medusa_logits,
                                              stream_tokens_medusa)
    from eamg_tpu_torch.models import gpt
    from eamg_tpu_torch.tools.medusa import (load_medusa_heads,
                                             probe_acceptance)
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    cfg = _cfg(inp, "model/cfg")
    params = params_from_jax(unflatten(inp, "model/p"))
    heads = _heads_from(inp, "model/heads")
    for i in range(int(inp["n_blocks"])):
        c = unflatten(inp, f"block/{i}/cache")
        cache = {"k": [_t(a) for a in c["k"]], "v": [_t(a) for a in c["v"]],
                 "length": torch.tensor([int(inp[f"block/{i}/t"])],
                                        dtype=torch.int32)}
        logits, h, cache = gpt.decode_block(
            params, _t(inp[f"block/{i}/ids"]).long(), cache, cfg,
            return_hidden=True)
        out[f"block/{i}/logits"] = logits.numpy()
        out[f"block/{i}/hidden"] = h.numpy()
        for j, a in enumerate(cache["k"] + cache["v"]):
            out[f"block/{i}/cache/{j}"] = a.numpy()
        out[f"block/{i}/length"] = cache["length"].numpy()
    out["medusa_logits"] = medusa_logits(heads, params,
                                         _t(inp["heads/h"])).numpy()
    out["probe"] = np.asarray(json.dumps(probe_acceptance(
        params, cfg, heads, inp["probe/ids"], 0)))
    max_len, gamma = int(inp["max_len"]), int(inp["gamma"])
    ids = [int(i) for i in inp["prompt"]]
    prompt = torch.zeros((1, 16), dtype=torch.int64)
    prompt[0, :len(ids)] = torch.tensor(ids)
    runs = json.loads(str(inp["runs"]))
    for name, kw in runs.items():
        kw = dict(kw)
        seed = kw.pop("seed", 0)
        buf, n, steps = generate_medusa(params, heads, prompt, len(ids),
                                        prng.PRNGKey(seed), cfg, max_len,
                                        gamma=gamma, **kw)
        out[f"run/{name}/tokens"] = buf[0, :n].numpy()
        out[f"run/{name}/steps"] = np.asarray(steps)
    for name in json.loads(str(inp["streams"])):
        kw = dict(runs[name])
        seed = kw.pop("seed", 0)
        out[f"stream/{name}"] = np.asarray(list(stream_tokens_medusa(
            params, heads, cfg, ids, max_len, gamma=gamma, seed=seed, **kw)),
            np.int64)
    buf, n = generate_kv(params, prompt, len(ids), prng.PRNGKey(0), cfg,
                         max_len, greedy=True, refeed_last_prompt=False)
    out["kv_greedy"] = buf[0, :n].numpy()
    for tag in ("a", "b3"):
        hd = load_medusa_heads(str(inp[f"demo/{tag}"]) + "/medusa_heads.pkl")
        out[f"demo/{tag}/n"] = np.asarray(len(hd["blocks"]))
        for i, blk in enumerate(hd["blocks"]):
            for k, v in blk.items():
                out[f"demo/{tag}/{i}/{k}"] = v.numpy()
        out[f"demo/{tag}/probe"] = np.asarray(json.dumps(hd["probe"]))
    text, seed = "I finally got the job, I am so happy!", 5
    for tag in ("a", "b3"):
        pipe = _spec_pipeline(inp, tag)
        out[f"pipe/{tag}/oneshot"] = np.frombuffer(pipe.generate(
            text, seed=seed, render_audio=False, medusa=True).midi_bytes,
            np.uint8)
        out[f"pipe/{tag}/stream"] = np.asarray(json.dumps(list(
            pipe.generate_stream(text, seed=seed, render_audio=False,
                                 medusa=True))))
    _medusa_http(inp, out)
    with tempfile.TemporaryDirectory() as tmp:
        _heads_mismatch(inp, out, tmp)
    _checkpoint_probe(inp, out)


def _checkpoint_probe(inp, out):
    """The synthetic corpora and the probe of a heads file without one, on
    an f32 copy of demo_ckpt_b3."""
    import dataclasses

    from eamg_tpu_torch.tools.medusa import (load_medusa_heads,
                                             probe_heads_for_checkpoint)
    from eamg_tpu_torch.train.data import grid_corpus, synthetic_corpus
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    rows, seed = json.loads(str(inp["corpus"]))
    out["corpus/synthetic"] = np.asarray(json.dumps(synthetic_corpus(
        rows, seed=seed, tempo_locked=True)))
    out["corpus/grid"] = np.asarray(json.dumps(grid_corpus(rows, seed=seed)))
    path = str(inp["demo/b3"])
    ck = load_checkpoint(path)
    ck["params"] = _tree_f32(ck["params"])
    ck["cfg"] = dataclasses.replace(ck["cfg"], dtype="float32")
    heads = load_medusa_heads(path + "/medusa_heads.pkl")
    heads.pop("probe")
    out["ckpt_probe"] = np.asarray(json.dumps(probe_heads_for_checkpoint(
        ck, heads, rows=int(inp["ckpt_probe_rows"]), device=CPU)))


def _tree_f32(node):
    if isinstance(node, dict):
        return {k: _tree_f32(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_f32(v) for v in node]
    return node.float()


def _spec_cli(inp, out, tmp):
    import contextlib
    import os
    import subprocess

    from eamg_tpu_torch import cli

    ckpt = str(inp["cli/ckpt"])
    for name, extra in json.loads(str(inp["cli/runs"])).items():
        mid = os.path.join(tmp, f"{name}.mid")
        with contextlib.redirect_stdout(io.StringIO()):
            out[f"cli/{name}/code"] = np.asarray(cli.main(
                ["generate", "--device", "cpu", "--checkpoint", ckpt,
                 "--out", mid, *extra]))
        with open(mid, "rb") as f:
            out[f"cli/{name}/midi"] = np.frombuffer(f.read(), np.uint8)
    r = subprocess.run(
        [sys.executable, "-m", "eamg_tpu_torch.cli", "generate", "--device",
         "cpu", "--checkpoint", ckpt, "--out", os.path.join(tmp, "x.mid"),
         "--beams", "2", "--lookup"],
        capture_output=True, text=True, timeout=120)
    out["cli/both/code"] = np.asarray(r.returncode)
    out["cli/both/stderr"] = np.asarray(r.stderr[-500:])


def task_spec(inp, out):
    """tests/test_torch_spec.py: prompt lookup, beam search, the pipeline's
    lookup and beams, over HTTP, and cli generate's three options."""
    import tempfile

    from eamg_tpu_torch.decode.beam import generate_beam, rank_beams
    from eamg_tpu_torch.decode.loop import generate_kv
    from eamg_tpu_torch.decode.speculative import generate_prompt_lookup
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    cfg = _cfg(inp, "model/cfg")
    params = params_from_jax(unflatten(inp, "model/p"))
    eos = int(inp["eos"])
    for name, (ids, kw) in json.loads(str(inp["lookups"])).items():
        kw = dict(kw)
        seed = kw.pop("seed", 0)
        prompt = torch.zeros((1, 16), dtype=torch.int64)
        prompt[0, :len(ids)] = torch.tensor(ids)
        buf, n, steps = generate_prompt_lookup(
            params, prompt, len(ids), prng.PRNGKey(seed), cfg,
            int(inp["lookup_max"]), gamma=int(inp["gamma"]),
            ngram=int(inp["ngram"]), **kw)
        out[f"lookup/{name}/tokens"] = buf[0, :n].numpy()
        out[f"lookup/{name}/steps"] = np.asarray(steps)
    ids = json.loads(str(inp["lookups"]))["greedy"][0]
    prompt = torch.zeros((1, 16), dtype=torch.int64)
    prompt[0, :len(ids)] = torch.tensor(ids)
    buf, n = generate_kv(params, prompt, len(ids), prng.PRNGKey(0), cfg,
                         int(inp["lookup_max"]), greedy=True,
                         refeed_last_prompt=False)
    out["kv_greedy"] = buf[0, :n].numpy()
    ids = [int(i) for i in inp["beam_prompt"]]
    prompt = torch.zeros((1, 16), dtype=torch.int64)
    prompt[0, :len(ids)] = torch.tensor(ids)
    for name, (tag, K) in json.loads(str(inp["beams"])).items():
        p = params_from_jax(unflatten(inp, f"models/{tag}"))
        buf, gl, sc = generate_beam(p, prompt, len(ids), cfg,
                                    int(inp["beam_max"]), n_beams=K,
                                    eos_id=eos)
        out[f"beam/{name}/buf"], out[f"beam/{name}/gen_lens"] = buf, gl
        out[f"beam/{name}/scores"] = sc
        for lp in (0.0, 1.0, 2.0):
            rb, rg, _, norm = rank_beams(buf, gl, sc, lp)
            out[f"rank/{name}/{lp}/buf"] = rb
            out[f"rank/{name}/{lp}/gen_lens"] = rg
            out[f"rank/{name}/{lp}/norm"] = norm
    text, seed = "I finally got the job, I am so happy!", 5
    options = {"lookup": {"lookup": True}, "beams": {"beams": 4}}
    for tag in ("a", "b3"):
        pipe = _spec_pipeline(inp, tag, heads=False)
        for opt, kw in options.items():
            out[f"pipe/{tag}/{opt}"] = np.frombuffer(pipe.generate(
                text, seed=seed, render_audio=False, **kw).midi_bytes,
                np.uint8)
    base = {"prompt": text, "seed": seed}
    _http_calls(_spec_pipeline(inp, "b3", heads=False), {
        "lookup": ("?format=midi", {**base, "lookup": "1"}),
        "beams": ("?format=midi", {**base, "beams": "4"})}, out, "http")
    with tempfile.TemporaryDirectory() as tmp:
        _spec_cli(inp, out, tmp)


# ------------------------------------------------------------------ grammar

def _grammar_http(out):
    """grammar=1 on the shipped B3 demo (bf16) behind the server: the
    one-shot MIDI, the stream's events, and lookup with grammar."""
    import base64

    from eamg_tpu_torch.serve import pipeline_from_checkpoint
    from eamg_tpu_torch.serve.pipeline import DEMO_CKPT_B3

    pipe = pipeline_from_checkpoint(DEMO_CKPT_B3, device=CPU)
    gram, vocab = pipe.grammar(), pipe.scheme_b.vocab
    end = vocab.tok2id["[END_SEQ]"]
    base = {"prompt": "I finally got the job, I am so happy!", "seed": 5,
            "grammar": "1"}
    got = {}
    _http_calls(pipe, {
        "oneshot": ("?format=midi", base),
        "stream": ("?stream=1&format=midi", base),
        "lookup_grammar": ("", {**base, "lookup": "1"})}, got, "x")
    one = pipe.generate(base["prompt"], seed=base["seed"], grammar=True,
                        render_audio=False)
    events = [json.loads(line[6:]) for line in
              got["x/stream/body"].tobytes().decode().split("\n\n")
              if line.startswith("data: ")]
    streams = {"oneshot": (vocab.encode(one.tokens),
                           got["x/oneshot/body"].tobytes()
                           if bytes(one.midi_bytes)
                           == got["x/oneshot/body"].tobytes() else b""),
               "stream": (vocab.encode(events[0]["prompt_tokens"])
                          + [i for e in events if e["event"] == "tokens"
                             for i in e["ids"]],
                          base64.b64decode(events[-1].get("midi_b64", "")))}
    for name, (ids, midi) in streams.items():
        out[f"http/{name}/status"] = got[f"x/{name}/status"]
        out[f"http/{name}/violations"] = np.asarray(gram.violations(ids))
        out[f"http/{name}/ends_with_end"] = np.asarray(ids[-1] == end)
        out[f"http/{name}/midi"] = np.frombuffer(midi, np.uint8)
    out["http/lookup_grammar/status"] = got["x/lookup_grammar/status"]
    out["http/lookup_grammar/error"] = np.asarray(json.loads(
        got["x/lookup_grammar/body"].tobytes())["error"])


def task_grammar(inp, out):
    """tests/test_torch_grammar.py: the FSM tables, its device functions,
    every decode loop with a grammar, and grammar=1 over HTTP."""
    from eamg_tpu_torch.decode.beam import generate_beam
    from eamg_tpu_torch.decode.grammar import (grammar_a, grammar_b2,
                                               grammar_b3, grammar_mask,
                                               grammar_step,
                                               scan_prompt_state)
    from eamg_tpu_torch.decode.loop import generate_full, generate_kv
    from eamg_tpu_torch.decode.ragged import generate_kv_ragged
    from eamg_tpu_torch.decode.stream import stream_tokens
    from eamg_tpu_torch.tokenizer import SchemeB2, SchemeB3, Vocab
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    with open("eamg_tpu/serve/demo_ckpt_a/vocab.json") as f:
        vocab_a = Vocab(json.load(f))
    for tag, g in (("a", grammar_a(vocab_a)), ("b3", grammar_b3(SchemeB3())),
                   ("b2", grammar_b2(SchemeB2()))):
        for name in ("tclass", "allowed", "next_state", "closing",
                     "steps_to_close"):
            out[f"tables/{tag}/{name}"] = np.asarray(getattr(g, name))
        out[f"tables/{tag}/init_state"] = np.asarray(g.init_state)
        out[f"tables/{tag}/names"] = np.asarray(
            json.dumps([g.classes, g.states]))
        arr = g.arrays(CPU)
        if g.arrays(CPU) is not arr:
            raise AssertionError("arrays() made its tensors twice")
        for name, t in arr.items():
            out[f"arrays/{tag}/{name}"] = t.numpy()
        out[f"arrays/{tag}/init"] = arr["init"].numpy()[0]

    garr = grammar_b3(SchemeB3()).arrays(CPU)
    logits, gstate = _t(inp["fn/logits"]), _t(inp["fn/gstate"]).long()
    budget, row_on = _t(inp["fn/budget"]).long(), _t(inp["fn/row_on"])
    out["fn/mask_plain"] = grammar_mask(logits, gstate, garr).numpy()
    out["fn/mask_budget"] = grammar_mask(logits, gstate, garr,
                                         budget_left=budget).numpy()
    out["fn/mask_scalar"] = grammar_mask(logits, gstate, garr,
                                         budget_left=3).numpy()
    out["fn/mask_row_on"] = grammar_mask(logits, gstate, garr,
                                         budget_left=budget,
                                         row_on=row_on).numpy()
    tokens = _t(inp["fn/tokens"]).long()
    out["fn/step"] = grammar_step(gstate, tokens, garr).numpy()
    out["fn/step_active"] = grammar_step(gstate, tokens, garr,
                                         active=_t(inp["fn/active"])).numpy()
    prompts = _t(inp["fn/prompts"]).long()
    out["fn/scan"] = scan_prompt_state(garr, prompts,
                                       _t(inp["fn/plen"]).long()).numpy()
    out["fn/scan_scalar"] = scan_prompt_state(garr, prompts, 9).numpy()

    spec = json.loads(str(inp["spec"]))
    cfg = _cfg(inp, "cfg")
    params = params_from_jax(unflatten(inp, "p"))
    gram = grammar_a(Vocab(json.loads(str(inp["names"]))))
    prompt_ids, eos, pad = spec["prompt"], spec["eos"], spec["pad"]
    p, max_len = len(prompt_ids), spec["max_len"]

    def bucket(ids, batch=1, width=16):
        row = torch.full((batch, width), pad, dtype=torch.int64)
        row[:, :len(ids)] = torch.tensor(ids)
        return row

    for name, kw in spec["solo"].items():
        kw = dict(kw)
        seed, batch = kw.pop("seed", 0), kw.pop("batch", 1)
        ml = kw.pop("max_len", max_len)
        buf, n = generate_kv(params, bucket(prompt_ids, batch, min(16, ml)),
                             p, prng.PRNGKey(seed), cfg, ml, top_k=40,
                             eos_id=eos, pad_id=pad, grammar=gram, **kw)
        out[f"solo/{name}"] = buf[:, :n].numpy()
    kw = dict(spec["stream"])
    out["stream"] = np.asarray(list(stream_tokens(
        params, cfg, prompt_ids, max_len, top_k=40, eos_id=eos, pad_id=pad,
        grammar=gram, **kw)), np.int64)
    out["beam/buf"], out["beam/gen_lens"], out["beam/scores"] = \
        generate_beam(params, bucket(prompt_ids), p, cfg, max_len,
                      n_beams=spec["beams"], eos_id=eos, pad_id=pad,
                      grammar=gram)
    buf, n = generate_full(params, bucket(prompt_ids), p,
                           prng.PRNGKey(spec["full_seed"]), cfg, max_len,
                           top_k=40, eos_id=eos, pad_id=pad, grammar=gram)
    out["full"] = buf[:, :n].numpy()
    prompts = _t(inp["ragged/prompts"]).long()
    for name, kw in spec["ragged"].items():
        kw = dict(kw)
        kw["grammar"] = gram if kw.get("grammar") else None
        buf, n = generate_kv_ragged(
            params, prompts, inp["ragged/lens"],
            prng.key_rows(spec["ragged_seeds"]), cfg, max_len, top_k=40,
            eos_id=eos, pad_id=pad, **kw)
        out[f"ragged/{name}/buf"] = buf.numpy()
        out[f"ragged/{name}/lengths"] = n.numpy()
    _grammar_http(out)


# -------------------------------------------------------------------- train

def _ragged(rows) -> np.ndarray:
    return np.asarray(json.dumps([[int(v) for v in r] for r in rows]))


def _train_data_checks(inp, out):
    """tests/test_torch_train.py: the host data functions on the test's
    inputs."""
    from eamg_tpu_torch.train import data
    from eamg_tpu_torch.train.run import encode_corpus, encode_corpus_csv

    spec = json.loads(str(inp["data/spec"]))
    encoded = spec["encoded"]
    T, pad = spec["seq_len"], spec["pad"]
    for name, kw in spec["batches"].items():
        got = list(data.batches(encoded, T, pad, **kw))
        out[f"data/batches/{name}/x"] = np.stack([x for x, _ in got])
        out[f"data/batches/{name}/y"] = np.stack([y for _, y in got])
    for name, kw in spec["packed"].items():
        got = list(data.packed_batches(encoded, T, pad, **kw))
        for i, part in enumerate("xys"):
            out[f"data/packed/{name}/{part}"] = np.stack(
                [b[i] for b in got]) if got else np.zeros((0,), np.int32)
    shifted = [data.pad_and_shift(r, T, pad) for r in encoded]
    out["data/shift/x"] = np.stack([x for x, _ in shifted])
    out["data/shift/y"] = np.stack([y for _, y in shifted])
    out["data/pack/rows"], out["data/pack/segs"] = data.pack_rows(encoded, T,
                                                                  pad)
    csv_path = str(inp["data/csv"])
    data.write_synthetic_csv(csv_path, spec["csv_rows"], seed=spec["csv_seed"])
    with open(csv_path, "rb") as f:
        out["data/csv_bytes"] = np.frombuffer(f.read(), np.uint8)
    out["data/csv_tokens"] = np.asarray(json.dumps(list(
        data.iter_csv_tokens(csv_path, max_rows=spec["csv_max_rows"]))))
    rows = json.loads(str(inp["data/corpus"]))
    for scheme in ("a", "b1", "b2", "b3"):
        enc, vocab = encode_corpus(rows, scheme, spec["corpus_seq_len"])
        out[f"data/corpus/{scheme}/ids"] = _ragged(enc)
        out[f"data/corpus/{scheme}/vocab"] = np.asarray(
            json.dumps(vocab.tok2id))
        enc, vocab = encode_corpus_csv(csv_path, scheme,
                                       spec["corpus_seq_len"], max_rows=5)
        out[f"data/csv/{scheme}/ids"] = _ragged(enc)
        out[f"data/csv/{scheme}/vocab"] = np.asarray(json.dumps(vocab.tok2id))


def _named_leaves(tree, prefix: str) -> dict:
    """A tree of tensors -> {"prefix/a/0/b": numpy} (bf16 as float32)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            out[path] = _np(node.detach())

    walk(tree, prefix)
    return out


def _train_loss_checks(inp, out):
    """loss_fn / loss_fn_packed / loss_fn_chunked and their gradients for
    every case of the test."""
    from eamg_tpu_torch.train import trainer as tr
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    for name in json.loads(str(inp["loss/cases"])):
        p = f"loss/{name}"
        cfg = _cfg(inp, f"{p}/cfg")
        spec = json.loads(str(inp[f"{p}/spec"]))
        params = tr.tree_map(lambda t: t.requires_grad_(),
                             params_from_jax(unflatten(inp, f"{p}/p")))
        x, y = _t(inp[f"{p}/x"]).long(), _t(inp[f"{p}/y"]).long()
        seg = _t(inp[f"{p}/seg"]).long() if f"{p}/seg" in inp else None
        if spec["chunk"]:
            loss, count = tr.loss_fn_chunked(params, x, y, cfg, 0,
                                             spec["chunk"], seg=seg)
        elif seg is not None:
            loss, count = tr.loss_fn_packed(params, x, y, seg, cfg, 0)
        else:
            loss, count = tr.loss_fn(params, x, y, cfg, 0)
        leaves = tr.tree_leaves(params)
        grads = torch.autograd.grad(loss, leaves)
        out[f"{p}/loss"] = np.asarray(float(loss))
        out[f"{p}/count"] = np.asarray(int(count))
        out.update(_named_leaves(tr.tree_unflatten(params, grads),
                                 f"{p}/grad"))


def _tcfg(inp, key):
    from eamg_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(**json.loads(str(inp[key])))


def _train_trainer_checks(inp, out):
    """3 Trainer steps per case from the test's params and batches."""
    from eamg_tpu_torch.train.trainer import Trainer
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    for name in json.loads(str(inp["trainer/cases"])):
        p = f"trainer/{name}"
        t = Trainer(_cfg(inp, f"{p}/cfg"), _tcfg(inp, f"{p}/tcfg"),
                    params_from_jax(unflatten(inp, f"{p}/p")), device=CPU)
        xs, ys = inp[f"{p}/x"], inp[f"{p}/y"]
        ms = [t.train_step(xs[i], ys[i]) for i in range(xs.shape[0])]
        for k in ("loss", "tokens", "lr", "grad_norm"):
            if k in ms[0]:
                out[f"{p}/{k}"] = np.asarray([m[k] for m in ms], np.float64)
        out.update(_named_leaves(t.params, f"{p}/params"))


def _train_checkpoint_checks(inp, out):
    """Port save -> (the test's JAX load); JAX save with opt_state -> port
    load and 2 more steps; init_params from a threefry key; the served
    forward of an attn_block model."""
    from eamg_tpu_torch.models.gpt import forward, init_params
    from eamg_tpu_torch.train.trainer import Trainer, tree_map
    from eamg_tpu_torch.utils import prng
    from eamg_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                 params_from_jax,
                                                 save_checkpoint)

    for name in json.loads(str(inp["init/cases"])):
        cfg = _cfg(inp, f"init/{name}/cfg")
        out.update(_named_leaves(init_params(prng.PRNGKey(
            int(inp[f"init/{name}/seed"])), cfg), f"init/{name}/p"))

    cfg, tcfg = _cfg(inp, "ckpt/cfg"), _tcfg(inp, "ckpt/tcfg")
    vocab = json.loads(str(inp["ckpt/vocab"]))
    xs, ys = inp["ckpt/x"], inp["ckpt/y"]
    t = Trainer(cfg, tcfg, init_params(prng.PRNGKey(3), cfg), device=CPU)
    t.train_step(xs[0], ys[0])
    save_checkpoint(str(inp["ckpt/port_dir"]), t.params, vocab, cfg,
                    opt_state=t.opt_state_tree(), step=t.step,
                    extra={"preset": "test"}, tcfg=tcfg)
    save_checkpoint(str(inp["ckpt/port_bf16_dir"]),
                    tree_map(lambda a: a.to(torch.bfloat16), t.params),
                    vocab, cfg, step=t.step)
    out.update(_named_leaves(t.params, "ckpt/port_params"))
    out.update(_named_leaves(t.opt_state_tree()["mu"], "ckpt/port_mu"))

    ck = load_checkpoint(str(inp["ckpt/jax_dir"]))
    r = Trainer(ck["cfg"], tcfg, ck["params"], device=CPU)
    r.load_opt_state(ck["opt_state"])
    r.step = ck["step"]
    out["ckpt/resume/step0"] = np.asarray(r.step)
    out["ckpt/resume/count0"] = np.asarray(r.opt_state["count"])
    out["ckpt/resume/loss"] = np.asarray(
        [r.train_step(xs[i], ys[i])["loss"] for i in (1, 2)])
    out.update(_named_leaves(r.params, "ckpt/resume/params"))

    bcfg = _cfg(inp, "block/cfg")
    params = params_from_jax(unflatten(inp, "block/p"))
    out["block/logits"] = forward(params, _t(inp["block/ids"]).long(),
                                  bcfg).numpy()


def task_train(inp, out):
    """tests/test_torch_train.py: the data functions, init_params, the
    losses and their gradients, three Trainer steps per case, the
    checkpoint round trips and the served forward of an attn_block
    model."""
    _train_data_checks(inp, out)
    _train_loss_checks(inp, out)
    _train_trainer_checks(inp, out)
    _train_checkpoint_checks(inp, out)


def _replay_checks(inp, out):
    """perplexity, teacher_forced_logits and verify_stream on the test's
    params and ids."""
    from eamg_tpu_torch.decode.replay import (perplexity,
                                              teacher_forced_logits,
                                              verify_stream)
    from eamg_tpu_torch.utils.checkpoint import params_from_jax

    cfg = _cfg(inp, "replay/cfg")
    params = params_from_jax(unflatten(inp, "replay/p"))
    spec = json.loads(str(inp["replay/spec"]))
    out["replay/ppl"] = np.asarray(perplexity(
        params, cfg, inp["replay/ppl_ids"], pad_id=0, batch=spec["batch"]))
    ids = inp["replay/ids"]
    for refeed in (True, False):
        out[f"replay/tf/{int(refeed)}"] = teacher_forced_logits(
            params, ids, spec["prompt_len"], cfg,
            refeed_last_prompt=refeed).numpy()
    v = verify_stream(params, cfg, inp["replay/stream"], spec["prompt_len"],
                      **spec["verify"])
    for k, val in v.items():
        out[f"replay/verify/{k}"] = np.asarray(val)


def _run_training_checks(inp, out, tmp):
    """run_training on the test's runs; the final checkpoints' params."""
    from eamg_tpu_torch.train.run import run_training
    from eamg_tpu_torch.utils.checkpoint import load_checkpoint

    for name, kw in json.loads(str(inp["run/cases"])).items():
        d = f"{tmp}/run_{name}"
        lines = []
        s = run_training(out_dir=d, log_fn=lines.append, device=CPU, **kw)
        out[f"run/{name}/summary"] = np.asarray(json.dumps(
            {k: v for k, v in s.items() if k != "out_dir"}))
        out[f"run/{name}/log"] = np.asarray(json.dumps(lines))
        out[f"run/{name}/dirs"] = np.asarray(json.dumps(sorted(
            os.listdir(d))))
        out.update(_named_leaves(load_checkpoint(f"{d}/final")["params"],
                                 f"run/{name}/final"))


def _demo_checks(inp, out):
    from eamg_tpu_torch.tools.demo_a import DemoASpec, train_demo_a

    spec = DemoASpec(**json.loads(str(inp["demo/spec"])))
    out["demo/metrics"] = np.asarray(json.dumps(train_demo_a(
        str(inp["demo/dir"]), spec=spec, log_fn=lambda m: None,
        device=CPU)))


def _train_cli_checks(inp, out, tmp):
    """cli train on the CPU, cli generate from its final checkpoint, and
    the mesh flags: a mesh larger than the host's cards (none) refused,
    ``--fsdp`` with a mesh of one trained."""
    from eamg_tpu_torch import cli

    ck = f"{tmp}/cli_ckpt"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = cli.main(["train", "--device", "cpu", "--preset", "mini",
                         "--synthetic", "16", "--epochs", "1", "--out", ck,
                         "--log-every", "0", "--d-model", "64", "--seq-len",
                         "64"])
    out["cli/train_code"] = np.asarray(code)
    out["cli/train_summary"] = np.asarray(buf.getvalue().splitlines()[-1])
    mid, wav = f"{tmp}/g.mid", f"{tmp}/g.wav"
    with contextlib.redirect_stdout(io.StringIO()):
        out["cli/generate_code"] = np.asarray(cli.main([
            "generate", "--device", "cpu", "--checkpoint", f"{ck}/final",
            "--bpm", "120", "--key", "C major", "--instruments", "Violin",
            "--max-len", "48", "--out", mid, "--wav", wav, "--seed", "1"]))
    with open(mid, "rb") as f:
        out["cli/midi"] = np.frombuffer(f.read()[:4], np.uint8)
    with open(wav, "rb") as f:
        out["cli/wav"] = np.frombuffer(f.read()[:12], np.uint8)
    refusals = json.loads(str(inp["cli/refusals"]))
    for name, argv in refusals.items():
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()):
            out[f"cli/refuse/{name}/code"] = np.asarray(cli.main(
                argv + ["--out", f"{tmp}/refuse_{name}"]))
        out[f"cli/refuse/{name}/stderr"] = np.asarray(err.getvalue())


def _grad_refusal_checks(out):
    """Every kernel wrapper refuses an input that requires grad while
    autograd records, on the CPU too; under no_grad it runs, and so does
    the serving forward with params that require grad."""
    from eamg_tpu_torch.models.gpt import GPTConfig, forward, init_params
    from eamg_tpu_torch.ops import attention, decode_attention, decode_fold
    from eamg_tpu_torch.ops import ffn, topk
    from eamg_tpu_torch.train.trainer import Trainer, TrainConfig, tree_map
    from eamg_tpu_torch.train.run import run_training
    from eamg_tpu_torch.tools.demo_a import train_demo_a
    from eamg_tpu_torch.utils import prng

    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)

    q4, kv4 = r(2, 4, 1, 16), r(2, 4, 8, 16)
    q3, kv3 = r(2, 1, 64), r(2, 8, 128)
    t = torch.tensor([5, 7], dtype=torch.int32)
    x, w1, b1, w2, b2 = r(3, 64), r(128, 64), r(128), r(64, 128), r(64)
    calls = {
        "flash_attention": lambda q: attention.flash_attention(
            q, r(2, 4, 6, 16), r(2, 4, 6, 16)),
        "fused_ffn": lambda w: ffn.fused_ffn(x, w, b1, w2, b2),
        "flash_decode_sp": lambda q: decode_attention.flash_decode_sp(
            q, kv4, kv4, t),
        "flash_decode": lambda q: decode_attention.flash_decode(
            q, kv4, kv4, t[:1]),
        "flash_decode_vmem": lambda q: decode_attention.flash_decode_vmem(
            q, kv4, kv4, t[:1]),
        **{name: (lambda fn: lambda q: fn(q, kv3, t, 4))(
            getattr(decode_fold, name))
           for name in ("flash_decode_fold", "flash_decode_fold3",
                        "flash_decode_fold_sp", "flash_decode_fold3_sp")},
        "flash_decode_fold2": lambda q: decode_fold.flash_decode_fold2(
            q, kv3, t, 4, rows=2),
        "kth_value": lambda lg: topk.kth_value(lg, 3),
        "top_k_mask": lambda lg: topk.top_k_mask(lg, 3),
        "stream_reduce": lambda kv: decode_fold.stream_reduce(kv, rows=2),
    }
    first = {"flash_attention": lambda: r(2, 4, 6, 16), "fused_ffn": lambda:
             w1.clone(), "kth_value": lambda: r(2, 40),
             "top_k_mask": lambda: r(2, 40), "stream_reduce": lambda:
             r(4, 8, 128)}
    for name, fn in calls.items():
        make = first.get(name, (lambda: q3.clone()) if "fold" in name
                         else (lambda: q4.clone()))
        out[f"grad/{name}/raised"] = _raised(
            lambda: fn(make().requires_grad_()))
        with torch.no_grad():
            out[f"grad/{name}/no_grad"] = _raised(
                lambda: fn(make().requires_grad_()))
        out[f"grad/{name}/plain"] = _raised(lambda: fn(make()))
    cfg = GPTConfig(vocab_size=20, seq_len=9, d_model=32, n_head=4,
                    n_layer=1, causal=True)
    params = init_params(prng.PRNGKey(0), cfg)
    live = tree_map(lambda p: p.clone().requires_grad_(), params)
    ids = torch.arange(8)[None] % 20
    out["grad/serving_forward_equal"] = np.asarray(bool(torch.equal(
        forward(live, ids, cfg), forward(params, ids, cfg))))
    defaults = {
        "Trainer": lambda: Trainer(cfg, TrainConfig(), params),
        "run_training": lambda: run_training("mini", synthetic_rows=4),
        "train_demo_a": lambda: train_demo_a("/nonexistent"),
    }
    for name, fn in defaults.items():
        out[f"default/{name}"] = _raised(fn)


def task_train_run(inp, out):
    """tests/test_torch_train_run.py: the replay functions, run_training,
    train_demo_a, cli train and generate, the CLI's refusals and the
    kernel wrappers' refusal of inputs that require grad."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _replay_checks(inp, out)
        _run_training_checks(inp, out, tmp)
        _demo_checks(inp, out)
        _train_cli_checks(inp, out, tmp)
    _grad_refusal_checks(out)


TASKS = {"medusa": task_medusa, "spec": task_spec, "kernels": task_kernels, "topk": task_topk, "slice": task_slice,
         "ragged": task_ragged, "engine": task_engine, "batch": task_batch,
         "bf16": task_bf16, "graphs": task_graphs, "stream": task_stream,
         "b3": task_b3, "grammar": task_grammar, "train": task_train,
         "train_run": task_train_run}


def main():
    from torch_port_emotion import EMOTION_TASKS
    from torch_port_parallel import PARALLEL_TASKS
    from torch_port_spec2 import SPEC2_TASKS
    from torch_port_tools import TOOLS_TASKS
    from torch_port_variants import VARIANTS_TASKS

    TASKS.update(EMOTION_TASKS)
    TASKS.update(SPEC2_TASKS)
    TASKS.update(TOOLS_TASKS)
    TASKS.update(VARIANTS_TASKS)
    TASKS.update(PARALLEL_TASKS)
    task, src, dst = sys.argv[1:4]
    torch.manual_seed(0)
    out: dict = {}
    with np.load(src, allow_pickle=False) as inp:
        TASKS[task](inp, out)
    buf = io.BytesIO()
    np.savez(buf, **out)
    with open(dst, "wb") as f:
        f.write(buf.getvalue())


if __name__ == "__main__":
    main()
