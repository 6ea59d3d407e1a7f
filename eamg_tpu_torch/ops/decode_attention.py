"""Single-query cached attention: kernel K3 (``csrc/decode_attention.cu``)
and its plain version.

Replaces ``eamg_tpu/ops/decode_attention.py::flash_decode_sp``. The kernel
is GQA-native, takes the newest valid position per row ``t [B]`` and any
cache length M (the flagship's is 511).
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build

SPLIT = 64   # keys per split: CH in csrc/decode_attention.cu


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
    return _build.bind("decode_attention", "eamg_flash_decode",
                       [P, P, P, P, P, P, I, I, I, I, I, F, I, P])


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Attention of q [B, H, 1, Dh] over cache positions 0..t[b] of
    k/v [B, Hkv, M, Dh]; t [B] int32. CPU tensors take
    :func:`decode_attention_plain`; CUDA tensors launch K3."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, t)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    B, H, one, Dh = q.shape
    Hkv, M = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in _build.DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"flash_decode: dtypes {q.dtype}/{k_cache.dtype}/"
                         f"{v_cache.dtype}; want one of float32, bfloat16")
    if one != 1 or k_cache.shape != (B, Hkv, M, Dh) \
            or v_cache.shape != k_cache.shape or H % Hkv \
            or Dh not in (16, 32, 64, 128):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)} cache "
                         f"{tuple(k_cache.shape)}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous()):
        raise ValueError("flash_decode: inputs must be contiguous")
    if t.shape != (B,) or t.dtype != torch.int32 or t.device != q.device:
        raise ValueError("flash_decode: t must be [B] int32 on the inputs' "
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
    _build.check(err, "flash_decode")
    _build.count_launch("flash_decode")
    return o
