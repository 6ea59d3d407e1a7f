"""Fold decode attention over a position-major fused KV cache, and the
stream-reduce probe: the kernels of ``csrc/decode_fold.cu`` and
``csrc/stream_reduce.cu`` with their plain versions.

Replaces every function of ``eamg_tpu/ops/decode_fold.py`` that reaches a
Pallas kernel, each under its JAX name: ``flash_decode_fold_sp`` and
``flash_decode_fold3_sp`` (the engine's), ``flash_decode_fold``,
``flash_decode_fold2`` and ``flash_decode_fold3`` (the batched decode's),
each one launch that reads the prefix 0..t[b] of each row only, and
``stream_reduce``.

The cache keeps K and V fused and position-major, ``kv [B, M, 2 * KVD]``
with K at ``[..., :KVD]``: the tail of the fused QKV projection, so a
decode step writes one contiguous ``[B, 2 * KVD]`` slice per layer and
never splits heads. q is ``[B, 1, D]`` and the result ``[B, 1, D]``, both
in concat-heads order, and ``t`` (a scalar or ``[B]``) is each row's
newest valid position, so the same function serves a uniform batch, the
ragged decode and the continuous-batching engine. q may be a view of the
fused QKV projection (rows ``D`` contiguous elements, any row stride; for
``flash_decode_fold_sp`` and ``_fold3_sp`` a multiple of 16 bytes, as the
projection's ``D + 2 * KVD`` is).

All five decode entry points compute one function; they differ in their
kernels (see the CUDA source) and, in bf16, in where the probabilities are
rounded. ``flash_decode_fold_sp`` and ``flash_decode_fold3_sp`` are one
function with one rounding, as their TPU kernels are: p = exp(s - m) is
rounded to the cache dtype unnormalised against the running max m of
128-key blocks (:data:`SP_BLOCK_K`) and the f32 sum divides after the
product with the values. Both launch K3's kernel (``ops/decode_attention``)
built for the fused layout, with K3's plan (``sp_plan``: by head, or over
spans of the keys), t read on the card. ``flash_decode_fold`` and
``flash_decode_fold2`` round p unnormalised against the global max;
``flash_decode_fold3`` divides first. Those three launch one cluster
kernel, one cluster of C blocks per batch row (C as :func:`cluster_size`
picks for the card), block rank r on the keys [r * R, (r + 1) * R) of the
row's t[b] + 1 valid ones, R = ceil((t[b] + 1) / C), with the rounding
that :data:`ROUNDING` names (so ``flash_decode_fold`` and
``flash_decode_fold2`` launch the same kernel, under their own names).
:data:`fold_decode` names the one the ragged decode and the engine call.
On the CPU every wrapper takes :func:`decode_attention_pm_plain`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build, decode_attention

# the fewest lines a block of the stream-reduce probe takes (MIN_SLAB in
# csrc/stream_reduce.cu), which sizes its partials
STREAM_MIN_SLAB = 64
# The key blocks whose running max p = exp(s - max) is rounded against on
# the card before p.v, as the TPU kernels of flash_decode_fold_sp and
# flash_decode_fold3_sp round it (their block_k = min(128, M)): one entry
# for both wrappers, which compute one function (K3's, csrc/
# decode_attention.cu)
SP_BLOCK_K = decode_attention.BLOCK_K["flash_decode_sp"]
# key rows one tensor copy of that kernel brings from the fused cache (the
# box of its tensor map: KV_BOX in csrc/decode_kernels.cuh)
SP_BOX = 32


def _row_positions(t, B: int, device) -> torch.Tensor:
    """t, a [B] or [1] int32 tensor on ``device``, as [B] (a [B] tensor is
    returned as it is: the kernel reads it in place, the host never does).
    A host value is refused on the card, where converting it would cost a
    copy a call that no CUDA graph can hold; on the CPU (the plain
    versions) an int or an integer tensor is taken too."""
    device = torch.device(device)
    if device.type == "cpu":
        t = torch.as_tensor(t, dtype=torch.int32)
    elif not isinstance(t, torch.Tensor) or t.device != device \
            or t.dtype != torch.int32:
        raise ValueError(
            f"t must be a [B] or [1] int32 tensor on {device} (the kernel "
            f"reads it there), got "
            + (f"{t.dtype} on {t.device}" if isinstance(t, torch.Tensor)
               else type(t).__name__))
    if t.shape == (B,):
        return t
    if t.numel() != 1:
        raise ValueError(f"t of shape {tuple(t.shape)} for {B} rows")
    return t.reshape(1).expand(B)


def decode_attention_pm_plain(q: torch.Tensor, kv: torch.Tensor, t,
                              n_head: int,
                              normalize: str = "before") -> torch.Tensor:
    """The JAX package's XLA reference on the position-major layout
    (``xla_decode_attention_pm``): grouped scores in the cache dtype, keys
    past ``t`` filled with ``finfo(dt).min``, softmax in f32 cast back,
    grouped values. That is ``normalize="before"``: the probabilities are
    divided by their sum before they are rounded to the cache dtype.

    ``normalize="after"`` is the order of ``flash_decode_fold`` and
    ``flash_decode_fold2``: ``exp(s - max)`` is rounded to the cache dtype
    unnormalised, multiplied with the values into an f32 sum, and that is
    divided by the f32 sum of the unrounded probabilities and rounded once.

    q [B, 1, D], kv [B, M, 2 * KVD], t scalar or [B] -> [B, 1, D]."""
    if normalize not in ("before", "after"):
        raise ValueError(f"normalize {normalize!r}: 'before' or 'after'")
    B, _, D = q.shape
    M = kv.shape[1]
    KVD = kv.shape[2] // 2
    Dh = D // n_head
    kv_heads = KVD // Dh
    g = n_head // kv_heads
    k = kv[..., :KVD].reshape(B, M, kv_heads, Dh)
    v = kv[..., KVD:].reshape(B, M, kv_heads, Dh)
    qg = q.reshape(B, kv_heads, g, Dh)
    s = torch.einsum("bkgd,bmkd->bkgm", qg, k) / math.sqrt(Dh)
    tb = torch.as_tensor(t, dtype=torch.int32, device=q.device).reshape(-1)
    tb = tb.expand(B) if tb.numel() == 1 else tb
    mask = (torch.arange(M, device=q.device)[None, None, None, :]
            <= tb[:, None, None, None])
    s = torch.where(mask, s, torch.finfo(s.dtype).min)
    if normalize == "before":
        p = torch.softmax(s.float(), dim=-1).to(q.dtype)
        o = torch.einsum("bkgm,bmkd->bkgd", p, v)
        return o.reshape(B, 1, D)
    s = s.float()
    p = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    o = torch.einsum("bkgm,bmkd->bkgd", p.to(q.dtype).float(), v.float())
    o = o / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return o.to(q.dtype).reshape(B, 1, D)


# Dh that the cluster kernel of flash_decode_fold, _fold2 and _fold3 takes
# (48: demo_ckpt_b3's heads)
CLUSTER_DH = (32, 48, 64, 128)


def _check_fold(name: str, q: torch.Tensor, kv: torch.Tensor, n_head: int,
                dh_taken=CLUSTER_DH) -> None:
    """What every fold kernel asks of CUDA inputs, with Dh in
    ``dh_taken``."""
    _build.require_cuda(name, q)
    if q.dim() != 3 or kv.dim() != 3 or q.shape[1] != 1 \
            or kv.shape[0] != q.shape[0] or kv.shape[2] % 2 \
            or q.shape[2] % n_head:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} kv "
                         f"{tuple(kv.shape)} n_head {n_head}")
    D, KVD = q.shape[2], kv.shape[2] // 2
    Dh = D // n_head
    if KVD % Dh or n_head % (KVD // Dh) or Dh not in dh_taken \
            or n_head // (KVD // Dh) not in (1, 2, 4, 8):
        raise ValueError(f"{name}: D {D}, KVD {KVD}, n_head {n_head}: want "
                         f"Dh in {dh_taken} and 1, 2, 4 or 8 query heads "
                         "per KV head")
    if q.dtype not in _build.DTYPE_CODE or kv.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{kv.dtype}; want one of "
                         "float32, bfloat16")
    if kv.device != q.device or q.stride(2) != 1 or not kv.is_contiguous():
        raise ValueError(f"{name}: kv must be contiguous, q's rows too, on "
                         "one device")


@functools.cache
def _launch_sp():
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("decode_fold", "eamg_fold_decode_sp",
                       [P, P, P, P, I, I, I, I, I, I, F, I, I, I, I, P])


def sp_plan(M: int, Dh: int, g: int, dtype: torch.dtype) -> tuple[bool, int]:
    """(by head, blocks a cluster) of the kernel of flash_decode_fold_sp and
    flash_decode_fold3_sp: K3's plan (``decode_attention.sp_plan``), from
    M, Dh, g and the dtype alone, never from B or t, so a row gets the same
    bits alone and inside any batch (the engine's same-seed contract)."""
    return decode_attention.sp_plan(
        M, Dh, g, dtype.itemsize,
        lambda: decode_attention.cluster_occupancy(M, Dh, g, SP_BLOCK_K,
                                                   dtype)[1], box=SP_BOX)


def _fold_sp(name: str, q: torch.Tensor, kv: torch.Tensor, t, n_head: int,
             C: int | None = None) -> torch.Tensor:
    """Rows 8 and 11 as wrapper ``name`` launches them: the plain version on
    CPU tensors; on CUDA tensors one launch of the kernel as
    :func:`sp_plan` says, or over spans of the keys with C blocks a (row,
    KV head) (chip_smoke.py checks the other sizes), t [B] passed as a
    device pointer."""
    _build.refuse_grad(name, q, kv)
    if q.device.type == "cpu":
        return decode_attention_pm_plain(q, kv, t, n_head)
    _check_fold(name, q, kv, n_head, decode_attention.DH_TAKEN)
    B, _, D = q.shape
    M, KVD = kv.shape[1], kv.shape[2] // 2
    Dh = D // n_head
    Hkv = KVD // Dh
    if (q.data_ptr() | kv.data_ptr() | q.stride(0) * q.element_size()) % 16:
        raise ValueError(f"{name}: q and kv must start on 16-byte boundaries "
                         "and q's rows lie a multiple of 16 bytes apart (the "
                         "kernel stages them by bulk copy)")
    by_head = False
    if C is None:
        by_head, C = sp_plan(M, Dh, n_head // Hkv, q.dtype)
    tb = _row_positions(t, B, q.device).contiguous()
    o = torch.empty((B, 1, D), dtype=q.dtype, device=q.device)
    err = _launch_sp()(q.data_ptr(), kv.data_ptr(), tb.data_ptr(),
                       o.data_ptr(), B, n_head, Hkv, M, Dh, q.stride(0),
                       1.0 / math.sqrt(Dh), SP_BLOCK_K, int(by_head), C,
                       _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q))
    _build.check(err, name, smem=f"Dh {Dh}, M {M}, g {n_head // Hkv}")
    _build.count_launch(name)
    return o


def flash_decode_fold_sp(q: torch.Tensor, kv: torch.Tensor, t,
                         n_head: int) -> torch.Tensor:
    """Attention of q [B, 1, D] over positions 0..t[b] of the fused cache
    kv [B, M, 2 * KVD] -> [B, 1, D]; t a scalar or [B] int. CPU tensors
    take :func:`decode_attention_pm_plain`; CUDA tensors launch K3's kernel
    over the fused cache once, p rounded against 128-key blocks."""
    return _fold_sp("flash_decode_fold_sp", q, kv, t, n_head)


def flash_decode_fold3_sp(q: torch.Tensor, kv: torch.Tensor, t,
                          n_head: int) -> torch.Tensor:
    """The same function as :func:`flash_decode_fold_sp`, with its
    rounding (the TPU kernels differ only in the axis their softmax
    reduces along): the same launch, under its own name."""
    return _fold_sp("flash_decode_fold3_sp", q, kv, t, n_head)


@functools.cache
def _launch_cluster():
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("decode_fold", "eamg_fold_decode_cluster",
                       [P, P, P, P, I, I, I, I, I, I, F, I, I, I, P])


@functools.cache
def _launch_occupancy():
    P, I = _build.P, _build.I
    return _build.bind("decode_fold", "eamg_fold_cluster_occupancy",
                       [I, I, I, I, I, I, I, P])


def cluster_size(active16: int) -> int:
    """Blocks in a batch row's cluster, from how many clusters of 16 blocks
    the card keeps resident at once at the shape: 16 (a non-portable size)
    wherever it can place one, else the portable 8. A cluster must fit in
    one GPC, so where a block's shared memory leaves room for one block an
    SM, a cluster of 16 needs 16 free SMs of one GPC, which a card with
    smaller GPCs does not have. On an H100 SXM clusters of 16 were faster
    at every shape timed, even where fewer than a batch's rows fit at once
    (PERF.md)."""
    return 16 if active16 > 0 else 8


@functools.cache
def cluster_occupancy(n_head: int, kv_heads: int, M: int, Dh: int,
                      normalize: str, dtype: torch.dtype) -> tuple[int, int]:
    """(clusters of 8, clusters of 16 blocks) of the cluster kernel with
    ``normalize``'s rounding that the current card keeps resident at once,
    at that shape, its blocks sized for ceil(M / C) keys, the most a block
    takes of a row."""
    out = []
    for C in (8, 16):
        active = (ctypes.c_int * 1)()
        err = _launch_occupancy()(n_head, kv_heads, Dh, -(-M // C),
                                  int(normalize == "before"), C,
                                  _build.DTYPE_CODE[dtype], active)
        _build.check(err, f"cluster occupancy, C {C}")
        out.append(active[0])
    return out[0], out[1]


# Where each wrapper of the cluster kernel rounds the probabilities
# (:func:`decode_attention_pm_plain`'s ``normalize``): flash_decode_fold and
# flash_decode_fold2 are one function with one rounding, as their TPU
# kernels are.
ROUNDING = {"flash_decode_fold": "after", "flash_decode_fold2": "after",
            "flash_decode_fold3": "before"}


def _fold_cluster(name: str, q: torch.Tensor, kv: torch.Tensor, t,
                  n_head: int, C: int | None = None) -> torch.Tensor:
    """The cluster kernel as wrapper ``name`` launches it, C blocks a batch
    row (None: :func:`cluster_size` of the card at this shape)."""
    normalize = ROUNDING[name]
    _build.refuse_grad(name, q, kv)
    if q.device.type == "cpu":
        return decode_attention_pm_plain(q, kv, t, n_head, normalize)
    _check_fold(name, q, kv, n_head)
    if kv.data_ptr() % 16:
        raise ValueError(f"{name}: kv must start on a 16-byte boundary")
    B, _, D = q.shape
    M, KVD = kv.shape[1], kv.shape[2] // 2
    Dh = D // n_head
    if C is None:
        C = cluster_size(cluster_occupancy(n_head, KVD // Dh, M, Dh,
                                           normalize, q.dtype)[1])
    tb = _row_positions(t, B, q.device).contiguous()
    o = torch.empty((B, 1, D), dtype=q.dtype, device=q.device)
    err = _launch_cluster()(q.data_ptr(), kv.data_ptr(), tb.data_ptr(),
                            o.data_ptr(), B, n_head, KVD // Dh, M, Dh,
                            q.stride(0), 1.0 / math.sqrt(Dh),
                            int(normalize == "before"), C,
                            _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q))
    _build.check(err, name, smem=f"n_head {n_head}, M {M}")
    _build.count_launch(name)
    return o


def flash_decode_fold(q: torch.Tensor, kv: torch.Tensor, t,
                      n_head: int) -> torch.Tensor:
    """Attention of q [B, 1, D] over positions 0..t[b] of the fused cache
    kv [B, M, 2 * KVD] -> [B, 1, D]; t a scalar or [B] int, the
    probabilities rounded unnormalised. CPU tensors take
    :func:`decode_attention_pm_plain` with ``normalize="after"``; CUDA
    tensors launch the cluster kernel, a cluster of blocks per batch row,
    which reads the prefix 0..t[b] only."""
    return _fold_cluster("flash_decode_fold", q, kv, t, n_head)


def flash_decode_fold2(q: torch.Tensor, kv: torch.Tensor, t, n_head: int,
                       rows: int = 4) -> torch.Tensor:
    """The function of :func:`flash_decode_fold`, with its rounding, and
    the same kernel. ``rows`` (``B % rows == 0``) is the TPU kernel's
    batch rows per program: it is checked as JAX checks it and shapes
    nothing here, so the result does not depend on it, to the bit."""
    if q.dim() == 3 and (rows <= 0 or q.shape[0] % rows):
        raise ValueError(f"flash_decode_fold2: batch {q.shape[0]} is no "
                         f"multiple of rows {rows}")
    return _fold_cluster("flash_decode_fold2", q, kv, t, n_head)


def flash_decode_fold3(q: torch.Tensor, kv: torch.Tensor, t,
                       n_head: int) -> torch.Tensor:
    """The same function with the probabilities divided by their sum
    before they are rounded (CPU: :func:`decode_attention_pm_plain`,
    ``"before"``); CUDA tensors launch the cluster kernel of
    :func:`flash_decode_fold2` with that rounding."""
    return _fold_cluster("flash_decode_fold3", q, kv, t, n_head)


# The decode attention of the ragged decode and the engine (the two
# wrappers launch one kernel). Every route of the coalesced path goes
# through this one entry point, which is what makes a row's stream the same
# on each of them.
fold_decode = flash_decode_fold_sp


def stream_reduce_plain(kv: torch.Tensor, rows: int = 4) -> torch.Tensor:
    """What the JAX package's ``stream_reduce`` returns for kv [B, M, W]:
    the f32 sum, cast back, over the lines of the LAST group of ``rows``
    batch rows, as [1, W]. Every grid step of the Pallas kernel writes the
    same output block, so the last one wins: the function is a read-rate
    probe and not a reduction of the whole array."""
    B, M, W = kv.shape
    groups = B // rows
    last = kv[(groups - 1) * rows:groups * rows].reshape(rows * M, W)
    return last.sum(dim=0, keepdim=True, dtype=torch.float32).to(kv.dtype)


@functools.cache
def _launch_stream():
    P, I = _build.P, _build.I
    return _build.bind("stream_reduce", "eamg_stream_reduce",
                       [P, P, P, P, I, I, I, I, P])


@functools.cache
def _stream_scratch(device: torch.device, groups: int, lines: int,
                    W: int) -> tuple:
    """The probe's f32 partials and its arrival counter (at 0, and left at
    0 by every launch), one pair a device and shape: calls of one shape
    share them, so they must not run on two streams at once."""
    part = torch.empty(groups * -(-lines // STREAM_MIN_SLAB) * W,
                       dtype=torch.float32, device=device)
    return part, torch.zeros(1, dtype=torch.int32, device=device)


def stream_reduce(kv: torch.Tensor, rows: int = 4) -> torch.Tensor:
    """kv [B, M, W] -> [1, W]: reads all ``B // rows`` groups of ``rows``
    batch rows and returns the last group's sum over its lines (see
    :func:`stream_reduce_plain`). CPU tensors take the plain version; CUDA
    tensors one launch of the kernel."""
    _build.refuse_grad("stream_reduce", kv)
    if kv.device.type == "cpu":
        return stream_reduce_plain(kv, rows)
    _build.require_cuda("stream_reduce", kv)
    if kv.dim() != 3 or rows <= 0 or kv.shape[0] < rows or kv.numel() == 0:
        raise ValueError(f"stream_reduce: kv {tuple(kv.shape)}, rows {rows}")
    if kv.dtype not in _build.DTYPE_CODE or not kv.is_contiguous():
        raise ValueError("stream_reduce: kv must be contiguous float32 or "
                         "bfloat16")
    B, M, W = kv.shape
    groups, lines = B // rows, rows * M
    part, arrived = _stream_scratch(kv.device, groups, lines, W)
    o = torch.empty((1, W), dtype=kv.dtype, device=kv.device)
    err = _launch_stream()(kv.data_ptr(), o.data_ptr(), part.data_ptr(),
                           arrived.data_ptr(), groups, lines, W,
                           _build.DTYPE_CODE[kv.dtype], _build.stream_ptr(kv))
    _build.check(err, "stream_reduce")
    _build.count_launch("stream_reduce")
    return o
