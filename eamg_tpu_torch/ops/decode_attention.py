"""Single-query cached attention over a head-major cache: the kernel of
``csrc/decode_attention.cu`` and its plain version.

Replaces ``eamg_tpu/ops/decode_attention.py::flash_decode_sp`` (K3),
``::flash_decode`` and ``::flash_decode_vmem``, each under the name of the
JAX function it replaces. Each call is one launch of a thread-block
cluster per (row, KV head) over the keys 0..t, with the length of the key
blocks whose running max the probabilities are rounded against as an
argument (:data:`BLOCK_K`), as each TPU kernel rounds them. K3 is
GQA-native and takes the newest valid position per row ``t [B]``, which
its kernel reads from device memory; where a block holds every key and
value of a KV head it goes by head (a block per query head of the group,
each key and value copied once to all of them), else over spans of the
keys as the other two do. Those take what their JAX namesakes take: MHA
caches and one scalar ``t`` for the whole batch, which their kernel also
reads from device memory (a one-element int32 tensor on the card, as the
TPU kernel reads it from scalar memory). All take any cache length M (the
flagship's is 511).
"""

from __future__ import annotations

import ctypes
import functools
import math
import operator

import torch

from . import _build

DH_TAKEN = (16, 32, 48, 64, 128)
# query heads a KV head that K3's kernel takes
G_TAKEN = (1, 2, 4, 8)
# Keys a block of each TPU loop, whose running max p = exp(s - max) is
# rounded against (for a key of block kb, the max over keys 0..min(t,
# bk (kb + 1) - 1)); 0: the global max (flash_decode_vmem's one pass).
# K3: block_k = min(128, M) (over M < 128 keys one block either way).
BLOCK_K = {"flash_decode_sp": 128, "flash_decode": 256,
           "flash_decode_vmem": 0}
# cluster sizes over spans by cache length: (longest M, blocks a (row,
# head)); past the last, 16 where the card places a cluster of 16, else 8.
# MHA (rows 5, 6 and K3 at g 1), and K3 with a group of g > 1 query heads
# a KV head
CLUSTER_BY_M = ((1024, 2), (4096, 4))
SP_GQA_CLUSTER_BY_M = ((1024, 8),)
# shared memory a block may take on sm_90: EAMG_MAX_SMEM in csrc/common.cuh
SMEM_MAX = 232448


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
                       [P, P, P, P, P, I, I, I, I, I, F, I, I, I, P])


def heads_smem(M: int, Dh: int, itemsize: int, box: int = 1) -> int:
    """Bytes of shared memory a block of K3's kernel by head takes: every
    key and value of a KV head (their rows padded to a multiple of
    ``box``, the key rows a copy brings: 1 head-major, ``decode_fold.
    SP_BOX`` over the fused cache), q, the scores, the 128-key blocks'
    maxima and factors, each warp's p.v and l (``HeadsSmem`` in
    csrc/decode_kernels.cuh, which chip_smoke.py holds this to)."""
    return (128 + 2 * -(-M // box) * box * Dh * itemsize + Dh * itemsize
            + 4 * M + 8 * -(-M // 128) + 4 * 8 * Dh + 4 * 8)


def sp_plan(M: int, Dh: int, g: int, itemsize: int, active16,
            box: int = 1) -> tuple[bool, int]:
    """(by head, blocks a cluster) of K3's launch, from M, Dh, g and the
    dtype's size alone, never from B or t (so a row gets the same bits at
    any B): by head, a cluster of g blocks, one a query head, where g > 1
    and a block holds every key and value of the KV head (rows padded to
    ``box``, see :func:`heads_smem`); else a cluster of
    :func:`cluster_size` blocks over spans of the keys."""
    if g > 1 and heads_smem(M, Dh, itemsize, box) <= SMEM_MAX:
        return True, g
    return False, cluster_size(M, g, active16)


def cluster_size(M: int, g: int, active16) -> int:
    """Blocks in the cluster of one (row, KV head) of the kernel over spans
    of the keys (K3 where it does not go by head, and the scalar-t
    wrappers at g 1), from the cache length M and the group g alone, never
    from B or t (so a row gets the same bits at any B): MHA 2 up to M 1024,
    4 up to M 4096; a group of g > 1 heads (a block scores g heads a key) 8
    up to M 1024; past these 16 where the card can place a cluster of 16
    (``active16`` resident at the shape, a callable asked only then), else
    8. The fastest on an H100 SXM (chip_sweep.py, PERF.md): MHA at B 8, H
    8 (M 511, 2048, 4096) and one row (M 16384, 60000), where at M 511
    clusters of 16 took ~1.5x as long as 2, their blocks starting up to ~9
    us apart; GQA-2 at one row (M 511, 2048, 16384)."""
    for longest, C in (CLUSTER_BY_M if g == 1 else SP_GQA_CLUSTER_BY_M):
        if M <= longest:
            return C
    return 16 if active16() > 0 else 8


def check_sp_args(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, t: torch.Tensor) -> None:
    """Raise on what K3 does not take: q [B, H, 1, Dh], caches
    [B, Hkv, M, Dh] with H / Hkv in :data:`G_TAKEN`, laid out as
    :func:`_check_layout` says, and t [B] int32 on their device."""
    B, H, one, Dh = q.shape
    Hkv, M = k_cache.shape[1], k_cache.shape[2]
    if one != 1 or k_cache.shape != (B, Hkv, M, Dh) \
            or v_cache.shape != k_cache.shape or H % Hkv \
            or H // Hkv not in G_TAKEN:
        raise ValueError(f"flash_decode_sp: shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)}; H / Hkv in {G_TAKEN}")
    _check_layout("flash_decode_sp", q, k_cache, v_cache)
    if t.shape != (B,) or t.dtype != torch.int32 or t.device != q.device:
        raise ValueError("flash_decode_sp: t must be [B] int32 on the inputs' "
                         "device")


def flash_decode_sp(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Attention of q [B, H, 1, Dh] over cache positions 0..t[b] of
    k/v [B, Hkv, M, Dh]; t [B] int32, H / Hkv in :data:`G_TAKEN`. CPU
    tensors take :func:`decode_attention_plain`; CUDA tensors launch K3's
    kernel once, as :func:`sp_plan` says, with t passed as a device
    pointer (the host never reads it)."""
    _build.refuse_grad("flash_decode_sp", q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, t)
    return _flash_decode_sp(q, k_cache, v_cache, t)


def _flash_decode_sp(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, t: torch.Tensor,
                     C: int | None = None) -> torch.Tensor:
    """K3 on CUDA tensors as :func:`sp_plan` says, or over spans of the
    keys with C blocks a (row, KV head) (chip_smoke.py and chip_sweep.py
    check and time the other sizes)."""
    _build.require_cuda("flash_decode_sp", q)
    check_sp_args(q, k_cache, v_cache, t)
    B, H, _, Dh = q.shape
    Hkv, M = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    by_head = False
    if C is None:
        by_head, C = sp_plan(M, Dh, g, q.element_size(), lambda: (
            cluster_occupancy(M, Dh, g, BLOCK_K["flash_decode_sp"],
                              q.dtype)[1]))
    o = torch.empty_like(q)
    t = t.contiguous()
    err = _launch()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                    t.data_ptr(), o.data_ptr(), B, H, Hkv, M, Dh,
                    1.0 / math.sqrt(Dh), int(by_head), C,
                    _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q))
    _build.check(err, "flash_decode_sp", smem=f"Dh {Dh}, M {M}, g {g}")
    _build.count_launch("flash_decode_sp")
    return o


def key_spans(t: int, M: int, C: int) -> list[tuple[int, int]]:
    """The keys [start, stop) that block rank r of a cluster of C blocks
    takes of one (row, KV head), as the cluster kernel computes them from
    that row's t: the valid keys 0..min(t, M - 1) spread evenly in rank
    order, the first (t + 1) % C ranks one key more."""
    nv = max(0, min(t, M - 1) + 1)
    base, rem = divmod(nv, C)
    starts = [r * base + min(r, rem) for r in range(C + 1)]
    return list(zip(starts[:-1], starts[1:]))


def span_blocks(start: int, stop: int, bk: int) -> range:
    """The key blocks of bk keys (the TPU loop's) that the keys
    [start, stop) touch: the blocks whose maxima a cluster block takes
    into every block's table (bk 0: the one block of the global max)."""
    if stop <= start:
        return range(0)
    return range(start // bk, (stop - 1) // bk + 1) if bk else range(1)


@functools.cache
def _launch_scalar_t():
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("decode_attention", "eamg_flash_decode_scalar_t",
                       [P, P, P, P, I, I, I, P, F, I, I, I, P])


@functools.cache
def _launch_occupancy():
    P, I = _build.P, _build.I
    return _build.bind("decode_attention", "eamg_decode_cluster_occupancy",
                       [I, I, I, I, I, I, P])


@functools.cache
def cluster_occupancy(M: int, Dh: int, g: int, bk: int,
                      dtype: torch.dtype) -> tuple[int, int]:
    """(clusters of 8, clusters of 16 blocks) of the cluster kernel with g
    query heads a KV head and key blocks of bk (:data:`BLOCK_K`) that the
    current card keeps resident at once at (M, Dh, dtype)."""
    out = []
    for C in (8, 16):
        active = (ctypes.c_int * 1)()
        err = _launch_occupancy()(M, Dh, g, bk, C,
                                  _build.DTYPE_CODE[dtype], active)
        _build.check(err, f"decode cluster occupancy, C {C}")
        out.append(active[0])
    return out[0], out[1]


def _check_layout(name: str, q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor) -> None:
    """What the cluster kernel takes beyond the shapes: tensors of one
    dtype (f32 or bf16) on one device, contiguous, each starting on a
    16-byte boundary (the kernel stages them by bulk copy), Dh in
    :data:`DH_TAKEN`."""
    if q.dtype not in _build.DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}; want one of float32, bfloat16")
    Dh, M = q.shape[3], k_cache.shape[2]
    if Dh not in DH_TAKEN or M <= 0:
        raise ValueError(f"{name}: Dh {Dh}, M {M}; want Dh in {DH_TAKEN}")
    if k_cache.device != q.device or v_cache.device != q.device \
            or not (q.is_contiguous() and k_cache.is_contiguous()
                    and v_cache.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous, on one device")
    if (q.data_ptr() | k_cache.data_ptr() | v_cache.data_ptr()) % 16:
        raise ValueError(f"{name}: q, k and v must start on 16-byte "
                         "boundaries (the kernel stages them by bulk copy)")


def _check_card(name: str, q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor) -> None:
    """CUDA tensors laid out as :func:`_check_layout` says."""
    _build.require_cuda(name, q)
    _check_layout(name, q, k_cache, v_cache)


def scalar_t(name: str, t, device: torch.device) -> torch.Tensor:
    """t of the scalar-t wrappers as the one-element int32 tensor the
    kernel reads on the card (the TPU kernel reads it from scalar memory):
    a tensor on ``device`` is taken as it is, never read by the host. On
    the CPU a Python int is taken too; on the card a host value is
    refused, since fetching or copying it would cost a sync or a copy a
    call and a CUDA graph cannot hold either."""
    if isinstance(t, torch.Tensor):
        if t.numel() != 1:
            raise ValueError(f"{name}: t is one scalar for the whole batch, "
                             f"got shape {tuple(t.shape)}")
        if device.type == "cpu" and t.device.type == "cpu" \
                and not t.dtype.is_floating_point:
            return t.reshape(1).to(torch.int32)
        if t.dtype != torch.int32 or t.device != device:
            raise ValueError(f"{name}: t must be int32 on {device}, got "
                             f"{t.dtype} on {t.device}")
        return t if t.dim() == 1 else t.reshape(1)
    if device.type != "cpu":
        raise ValueError(f"{name}: t must be a one-element int32 tensor on "
                         f"{device} (the kernel reads it there), got "
                         f"{type(t).__name__}")
    try:
        return torch.tensor([operator.index(t)], dtype=torch.int32)
    except TypeError:
        raise ValueError(f"{name}: t must be an integer, got "
                         f"{type(t).__name__}") from None


def _scalar_t(name: str, q: torch.Tensor, k_cache: torch.Tensor,
              v_cache: torch.Tensor, t, C: int | None = None
              ) -> torch.Tensor:
    """The cluster kernel as wrapper ``name`` launches it, C blocks a
    (row, head) (None: :func:`cluster_size` at this shape), t passed as a
    device pointer (:func:`scalar_t`)."""
    _build.refuse_grad(name, q, k_cache, v_cache)
    if q.dim() != 4 or q.shape[2] != 1 or k_cache.dim() != 4 \
            or v_cache.shape != k_cache.shape \
            or k_cache.shape[0] != q.shape[0] \
            or k_cache.shape[3] != q.shape[3]:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    if k_cache.shape[1] != q.shape[1]:
        raise ValueError(f"{name}: takes MHA caches only (q has "
                         f"{q.shape[1]} heads, the cache {k_cache.shape[1]})")
    t = scalar_t(name, t, q.device)
    B, H, _, Dh = q.shape
    M = k_cache.shape[2]
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, t.expand(B))
    _check_card(name, q, k_cache, v_cache)
    bk = BLOCK_K[name]
    if C is None:
        C = cluster_size(
            M, 1, lambda: cluster_occupancy(M, Dh, 1, bk, q.dtype)[1])
    o = torch.empty_like(q)
    err = _launch_scalar_t()(q.data_ptr(), k_cache.data_ptr(),
                             v_cache.data_ptr(), o.data_ptr(), B * H, M, Dh,
                             t.data_ptr(), 1.0 / math.sqrt(Dh), int(bk > 0),
                             C, _build.DTYPE_CODE[q.dtype],
                             _build.stream_ptr(q))
    _build.check(err, name, smem=f"Dh {Dh}, M {M}")
    _build.count_launch(name)
    return o


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, t) -> torch.Tensor:
    """Attention of q [B, H, 1, Dh] over cache positions 0..t of MHA caches
    k/v [B, H, M, Dh]; t one position for the whole batch, a one-element
    int32 tensor on the inputs' device (:func:`scalar_t`). CPU tensors take
    :func:`decode_attention_plain`; CUDA tensors launch the cluster kernel
    with the rounding of the TPU kernel's loop over 256-key blocks (one
    launch), which reads t on the card."""
    return _scalar_t("flash_decode", q, k_cache, v_cache, t)


def flash_decode_vmem(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, t) -> torch.Tensor:
    """The same function as :func:`flash_decode`; CUDA tensors launch the
    same kernel with the rounding of the TPU kernel's one-pass softmax (the
    global max). Neither reads a key past t."""
    return _scalar_t("flash_decode_vmem", q, k_cache, v_cache, t)
