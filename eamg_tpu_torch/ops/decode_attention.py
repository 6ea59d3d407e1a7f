"""Single-query cached attention over a head-major cache: the three
kernels of ``csrc/decode_attention.cu`` and their plain version.

Replaces ``eamg_tpu/ops/decode_attention.py::flash_decode_sp`` (K3),
``::flash_decode`` and ``::flash_decode_vmem``, each under the name of the
JAX function it replaces. K3 is GQA-native and takes the newest valid
position per row ``t [B]``. The other two take what their JAX namesakes
take: MHA caches and one scalar ``t`` for the whole batch, by value;
``flash_decode`` reads 256-key blocks up to ``t``, ``flash_decode_vmem``
the whole cache. All take any cache length M (the flagship's is 511).
"""

from __future__ import annotations

import functools
import math
import operator

import torch

from . import _build

SPLIT = 64     # keys per split: CH in csrc/decode_attention.cu
BLOCK_K = 256  # keys per block of flash_decode's loop: BK in the same file


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


@functools.cache
def _launch_scalar_t():
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("decode_attention", "eamg_flash_decode_scalar_t",
                       [P, P, P, P, I, I, I, I, F, I, I, P])


def _scalar_t(name: str, variant: int, q: torch.Tensor,
              k_cache: torch.Tensor, v_cache: torch.Tensor,
              t) -> torch.Tensor:
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
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if q.dtype not in _build.DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}; want one of float32, bfloat16")
    if Dh not in (16, 32, 64, 128) or M <= 0:
        raise ValueError(f"{name}: Dh {Dh}, M {M}; want Dh in (16, 32, 64, "
                         "128)")
    if k_cache.device != q.device or v_cache.device != q.device \
            or not (q.is_contiguous() and k_cache.is_contiguous()
                    and v_cache.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous, on one device")
    o = torch.empty_like(q)
    err = _launch_scalar_t()(q.data_ptr(), k_cache.data_ptr(),
                             v_cache.data_ptr(), o.data_ptr(), B * H, M, Dh,
                             t, 1.0 / math.sqrt(Dh), variant,
                             _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q))
    _build.check(err, name, smem=f"Dh {Dh}, M {M}")
    _build.count_launch(name)
    return o


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, t) -> torch.Tensor:
    """Attention of q [B, H, 1, Dh] over cache positions 0..t of MHA caches
    k/v [B, H, M, Dh]; t one integer for the whole batch. CPU tensors take
    :func:`decode_attention_plain`; CUDA tensors launch the kernel that
    loops over 256-key blocks up to t (one launch)."""
    return _scalar_t("flash_decode", 0, q, k_cache, v_cache, t)


def flash_decode_vmem(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, t) -> torch.Tensor:
    """The same function as :func:`flash_decode`; CUDA tensors launch the
    kernel that reads the whole cache and masks past t (one launch)."""
    return _scalar_t("flash_decode_vmem", 1, q, k_cache, v_cache, t)
