"""Prefill attention: kernel K1 (``csrc/attention.cu``) and its plain
version.

Replaces ``eamg_tpu/ops/attention.py::flash_attention``. The kernel is
GQA-native (k/v carry ``Hkv`` heads, shared by groups of ``H // Hkv`` query
heads) and takes per-row valid key counts ``[B]``, so a ragged prefill
gives each row its own length. In bf16 it runs on tensor cores and rounds
the probabilities to bf16 before P V against the running max of 128-key
tiles, as the TPU kernel does; in f32 it runs on CUDA cores.
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build

DH_TAKEN = (16, 32, 48, 64, 128)
# warps a block of the bf16 kernel (16 rows a warp): 4 was the fastest or
# within noise of it at every shape chip_sweep.py times (T 16 solo and
# batch, T 64, T 511); a row's arithmetic follows from its 16-row tile
# alone, so this choice moves no bit of the output
WARPS = 4


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len: torch.Tensor | None = None,
                    causal: bool = False) -> torch.Tensor:
    """The JAX model's XLA attention (models/gpt.py::attention): grouped
    scores in the input dtype, masked keys filled with ``finfo(dt).min``,
    softmax in f32 cast back, grouped values.

    q [B, H, T, Dh], k/v [B, Hkv, T, Dh]; valid_len None or [B] int."""
    B, H, T, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, T, Dh)
    s = torch.einsum("bkgqd,bkmd->bkgqm", qg, k) * (1.0 / math.sqrt(Dh))
    if causal or valid_len is not None:
        cols = torch.arange(Tk, device=q.device)
        mask = torch.ones((B, T, Tk), dtype=torch.bool, device=q.device)
        if valid_len is not None:
            mask = mask & (cols[None, None, :]
                           < valid_len.to(q.device)[:, None, None])
        if causal:
            mask = mask & (cols[None, None, :]
                           <= torch.arange(T, device=q.device)[None, :, None])
        s = torch.where(mask[:, None, None], s,
                        torch.finfo(s.dtype).min)
    probs = torch.softmax(s.float(), dim=-1).to(v.dtype)
    out = torch.einsum("bkgqm,bkmd->bkgqd", probs, v)
    return out.reshape(B, H, T, Dh)


@functools.cache
def _launch():
    P, I, F = _build.P, _build.I, _build.F
    return _build.bind("attention", "eamg_attention_fwd",
                       [P, P, P, P, P, I, I, I, I, I, I, F, I, I, P])


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               valid_len: torch.Tensor | None) -> None:
    """Raise on what K1 does not take: q [B, H, T, Dh] and k, v
    [B, Hkv, T, Dh] of one dtype (f32 or bf16), H a multiple of Hkv, Dh in
    :data:`DH_TAKEN`, contiguous, each starting on a 16-byte boundary (the
    kernel stages them in 16-byte copies); valid_len None or [B] int32 on
    their device. In f32 a block holds g * 32 threads: g at most 32."""
    B, H, T, Dh = q.shape
    Hkv = k.shape[1]
    if q.dtype not in _build.DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; want one of float32, bfloat16")
    if k.shape != (B, Hkv, T, Dh) or v.shape != k.shape or H % Hkv \
            or Dh not in DH_TAKEN \
            or (q.dtype == torch.float32 and (H // Hkv) * 32 > 1024):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}; Dh in "
                         f"{DH_TAKEN}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: inputs must be contiguous")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("flash_attention: q, k and v must start on 16-byte "
                         "boundaries (the kernel stages them in 16-byte "
                         "copies)")
    if valid_len is not None and (
            valid_len.shape != (B,) or valid_len.dtype != torch.int32
            or valid_len.device != q.device):
        raise ValueError("flash_attention: valid_len must be [B] int32 on "
                         "the inputs' device")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len: torch.Tensor | None = None,
                    causal: bool = False) -> torch.Tensor:
    """softmax(q k^T / sqrt(Dh) + mask) v: q [B, H, T, Dh], k/v
    [B, Hkv, T, Dh], valid_len [B] int32 keys per row (None = all T).
    CPU tensors take :func:`attention_plain`; CUDA tensors launch K1 (one
    launch). Refuses inputs that require grad while autograd records."""
    _build.refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, valid_len, causal)
    return _flash_attention(q, k, v, valid_len, causal, WARPS)


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor | None, causal: bool,
                     warps: int) -> torch.Tensor:
    """K1 on CUDA tensors with ``warps`` warps a block in bf16 (chip_sweep.py
    times the others)."""
    _build.require_cuda("flash_attention", q)
    check_args(q, k, v, valid_len)
    B, H, T, Dh = q.shape
    Hkv = k.shape[1]
    if valid_len is None:
        valid_len = torch.full((B,), T, dtype=torch.int32, device=q.device)
    valid_len = valid_len.contiguous()
    o = torch.empty_like(q)
    err = _launch()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    valid_len.data_ptr(), B, H, Hkv, T, Dh, int(causal),
                    1.0 / math.sqrt(Dh), warps, _build.DTYPE_CODE[q.dtype],
                    _build.stream_ptr(q))
    _build.check(err, "flash_attention")
    _build.count_launch("flash_attention")
    return o
