"""Single-query cached attention over a head-major cache: the kernels of
``csrc/decode_attention.cu`` and their plain version.

Replaces ``eamg_tpu/ops/decode_attention.py::flash_decode_sp`` (K3),
``::flash_decode`` and ``::flash_decode_vmem``, each under the name of the
JAX function it replaces. K3 is GQA-native and takes the newest valid
position per row ``t [B]``. The other two take what their JAX namesakes
take: MHA caches and one scalar ``t`` for the whole batch, by value. They
compute one function and differ only in where their TPU kernels round the
probabilities (:data:`BLOCKED`), so both launch one cluster kernel, a
thread-block cluster per (row, head) over the keys 0..t, with that
rounding as a flag. All take any cache length M (the flagship's is 511).
"""

from __future__ import annotations

import ctypes
import functools
import math
import operator

import torch

from . import _build

SPLIT = 64     # keys per split: CH in csrc/decode_attention.cu
BLOCK_K = 256  # keys per block of flash_decode's TPU loop: BK_TPU there
# Where each scalar-t wrapper's kernel takes the max that p = exp(s - max)
# is rounded against, as its TPU kernel does: flash_decode the running max
# of its loop over 256-key blocks (for a key of block kb, the max over keys
# 0..min(t, 256 (kb + 1) - 1)), flash_decode_vmem the global max.
BLOCKED = {"flash_decode": True, "flash_decode_vmem": False}
# cluster sizes by cache length: (longest M, blocks a (row, head)); past
# the last, 16 where the card places a cluster of 16, else 8
CLUSTER_BY_M = ((1024, 2), (4096, 4))


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           t: torch.Tensor) -> torch.Tensor:
    """The JAX model's XLA decode attention (models/gpt.py::decode_step):
    grouped scores in the cache dtype, keys past ``t`` filled with
    ``finfo(dt).min``, softmax in f32 cast back, grouped values.

    q [B, H, 1, Dh], caches [B, Hkv, M, Dh], t [B] int."""
    B, H, _, Dh = q.shape
    Hkv, M = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, 1, Dh)
    s = torch.einsum("bkgqd,bkmd->bkgqm", qg, k_cache) * (1.0 / math.sqrt(Dh))
    valid = (torch.arange(M, device=q.device)[None, :]
             <= t.to(q.device)[:, None])                      # [B, M]
    s = torch.where(valid[:, None, None, None, :], s,
                    torch.finfo(s.dtype).min)
    probs = torch.softmax(s.float(), dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqm,bkmd->bkgqd", probs, v_cache)
    return out.reshape(B, H, 1, Dh)


@functools.cache
def _launch():
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("decode_attention", "eamg_flash_decode_sp",
                       [P, P, P, P, P, P, I, I, I, I, I, F, I, P])


def flash_decode_sp(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Attention of q [B, H, 1, Dh] over cache positions 0..t[b] of
    k/v [B, Hkv, M, Dh]; t [B] int32. CPU tensors take
    :func:`decode_attention_plain`; CUDA tensors launch K3."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, t)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_sp: unsupported device {q.device}")
    B, H, one, Dh = q.shape
    Hkv, M = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _build.DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"flash_decode_sp: dtypes {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}; want one of float32, bfloat16")
    if one != 1 or k_cache.shape != (B, Hkv, M, Dh) \
            or v_cache.shape != k_cache.shape or H % Hkv \
            or Dh not in (16, 32, 64, 128):
        raise ValueError(f"flash_decode_sp: shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("flash_decode_sp: inputs must be contiguous")
    if t.shape != (B,) or t.dtype != torch.int32 or t.device != q.device:
        raise ValueError("flash_decode_sp: t must be [B] int32 on the inputs' "
                         "device")
    n_split = -(-M // SPLIT)
    part = torch.empty(B * H * n_split * (Dh + 2), dtype=torch.float32,
                       device=q.device)
    o = torch.empty_like(q)
    t = t.contiguous()
    err = _launch()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    t.data_ptr(), o.data_ptr(), part.data_ptr(),
                    B, H, Hkv, M, Dh, 1.0 / math.sqrt(Dh),
                    _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q))
    _build.check(err, "flash_decode_sp")
    _build.count_launch("flash_decode_sp")
    return o


def key_spans(t: int, M: int, C: int) -> list[tuple[int, int]]:
    """The keys [start, stop) that block rank r of a cluster of C blocks
    takes of one (row, head), as the cluster kernel computes them: the
    valid keys 0..min(t, M - 1) spread evenly in rank order, the first
    (t + 1) % C ranks one key more."""
    nv = max(0, min(t, M - 1) + 1)
    base, rem = divmod(nv, C)
    starts = [r * base + min(r, rem) for r in range(C + 1)]
    return list(zip(starts[:-1], starts[1:]))


def span_blocks(start: int, stop: int) -> range:
    """The 256-key blocks of flash_decode's TPU loop that the keys
    [start, stop) touch: the blocks whose maxima a cluster block pushes."""
    return range(start // BLOCK_K, (stop - 1) // BLOCK_K + 1) \
        if stop > start else range(0)


@functools.cache
def _launch_scalar_t():
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("decode_attention", "eamg_flash_decode_scalar_t",
                       [P, P, P, P, I, I, I, I, F, I, I, I, P])


@functools.cache
def _launch_occupancy():
    P, I = _build.P, _build.I
    return _build.bind("decode_attention", "eamg_decode_cluster_occupancy",
                       [I, I, I, I, I, P])


@functools.cache
def cluster_occupancy(M: int, Dh: int, blocked: bool,
                      dtype: torch.dtype) -> tuple[int, int]:
    """(clusters of 8, clusters of 16 blocks) of the scalar-t cluster kernel
    with ``blocked``'s rounding that the current card keeps resident at
    once at (M, Dh, dtype)."""
    out = []
    for C in (8, 16):
        active = (ctypes.c_int * 1)()
        err = _launch_occupancy()(M, Dh, int(blocked), C,
                                  _build.DTYPE_CODE[dtype], active)
        _build.check(err, f"decode cluster occupancy, C {C}")
        out.append(active[0])
    return out[0], out[1]


def scalar_t_cluster_size(M: int, active16) -> int:
    """Blocks in the cluster of one (row, head) of the scalar-t kernel, from
    the cache length M alone (so a row gets the same bits at any B): 2 up to
    M 1024, 4 up to M 4096, past it 16 where the card can place a cluster
    of 16 (``active16`` resident at the shape, a callable asked only then),
    else 8. The fastest on an H100 SXM at B 8, H 8 (M 511, 2048, 4096) and
    at one row (M 16384, 60000); at M 511 clusters of 16 took ~1.5x as
    long as 2, their blocks starting up to ~9 us apart (chip_sweep.py,
    PERF.md)."""
    for longest, C in CLUSTER_BY_M:
        if M <= longest:
            return C
    return 16 if active16() > 0 else 8


def _check_card(name: str, q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor) -> None:
    """What the cluster kernel takes beyond the shapes: CUDA tensors of one
    dtype (f32 or bf16) on one device, contiguous, each starting on a
    16-byte boundary (the kernel stages them by bulk copy), Dh 16, 32, 64
    or 128."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _build.DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}; want one of float32, bfloat16")
    Dh, M = q.shape[3], k_cache.shape[2]
    if Dh not in (16, 32, 64, 128) or M <= 0:
        raise ValueError(f"{name}: Dh {Dh}, M {M}; want Dh in (16, 32, 64, "
                         "128)")
    if k_cache.device != q.device or v_cache.device != q.device \
            or not (q.is_contiguous() and k_cache.is_contiguous()
                    and v_cache.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous, on one device")
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError(f"{name}: q, k and v must start on 16-byte "
                         "boundaries (the kernel stages them by bulk copy)")


def _scalar_t(name: str, q: torch.Tensor, k_cache: torch.Tensor,
              v_cache: torch.Tensor, t, C: int | None = None
              ) -> torch.Tensor:
    """The cluster kernel as wrapper ``name`` launches it, C blocks a
    (row, head) (None: :func:`scalar_t_cluster_size` at this shape)."""
    if q.dim() != 4 or q.shape[2] != 1 or k_cache.dim() != 4 \
            or v_cache.shape != k_cache.shape \
            or k_cache.shape[0] != q.shape[0] \
            or k_cache.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    if k_cache.shape[1] != q.shape[1]:
        raise ValueError(f"{name}: takes MHA caches only (q has "
                         f"{q.shape[1]} heads, the cache {k_cache.shape[1]})")
    if isinstance(t, torch.Tensor) and t.numel() != 1:
        raise ValueError(f"{name}: t is one scalar for the whole batch, got "
                         f"shape {tuple(t.shape)}")
    try:
        t = operator.index(t)     # a 0-d tensor on the card is fetched here
    except TypeError:
        raise ValueError(f"{name}: t must be an integer, got "
                         f"{type(t).__name__}") from None
    B, H, _, Dh = q.shape
    M = k_cache.shape[2]
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, torch.full((B,), t, dtype=torch.int32))
    _check_card(name, q, k_cache, v_cache)
    blocked = BLOCKED[name]
    if C is None:
        C = scalar_t_cluster_size(
            M, lambda: cluster_occupancy(M, Dh, blocked, q.dtype)[1])
    o = torch.empty_like(q)
    err = _launch_scalar_t()(q.data_ptr(), k_cache.data_ptr(),
                             v_cache.data_ptr(), o.data_ptr(), B * H, M, Dh,
                             t, 1.0 / math.sqrt(Dh), int(blocked), C,
                             _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q))
    _build.check(err, name, smem=f"Dh {Dh}, M {M}")
    _build.count_launch(name)
    return o


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, t) -> torch.Tensor:
    """Attention of q [B, H, 1, Dh] over cache positions 0..t of MHA caches
    k/v [B, H, M, Dh]; t one integer for the whole batch. CPU tensors take
    :func:`decode_attention_plain`; CUDA tensors launch the cluster kernel
    with the rounding of the TPU kernel's loop over 256-key blocks (one
    launch)."""
    return _scalar_t("flash_decode", q, k_cache, v_cache, t)


def flash_decode_vmem(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, t) -> torch.Tensor:
    """The same function as :func:`flash_decode`; CUDA tensors launch the
    same kernel with the rounding of the TPU kernel's one-pass softmax (the
    global max). Neither reads a key past t."""
    return _scalar_t("flash_decode_vmem", q, k_cache, v_cache, t)
