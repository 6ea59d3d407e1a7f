"""Fused FFN: kernel K2 (``csrc/ffn.cu``) and its plain version.

Replaces ``eamg_tpu/ops/ffn.py::fused_ffn``:
``act(x @ w1^T + b1) @ w2^T + b2`` with torch-layout weights, the
``[rows, FF]`` intermediate kept out of device memory.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from . import _build

_ACT = {"relu": 0, "gelu": 1}


def ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              activation: str = "relu") -> torch.Tensor:
    """The Pallas kernel's arithmetic: weights cast to the input dtype,
    products accumulated in f32, + b1 in f32, activation (exact gelu), h
    cast to the input dtype, second product in f32, + b2, cast. In f32 this
    is the JAX model's XLA FFN (models/gpt.py::_mlp)."""
    dt = x.dtype
    h = x.float() @ w1.to(dt).float().T + b1.float()
    h = F.gelu(h) if activation == "gelu" else torch.relu(h)
    out = h.to(dt).float() @ w2.to(dt).float().T + b2.float()
    return out.to(dt)


@functools.cache
def _launch():
    P, I = _build.P, _build.I
    return _build.bind("ffn", "eamg_fused_ffn",
                       [P, P, P, P, P, P, P, I, I, I, I, I, P])


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor,
              activation: str = "relu") -> torch.Tensor:
    """x [..., D], w1 [FF, D], b1 [FF], w2 [D, FF], b2 [D] -> [..., D].
    CPU tensors take :func:`ffn_plain`; CUDA tensors launch K2."""
    if x.device.type == "cpu":
        return ffn_plain(x, w1, b1, w2, b2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    if x.dtype not in _build.DTYPE_CODE:
        raise ValueError(f"fused_ffn: dtype {x.dtype}; want float32 or "
                         "bfloat16")
    if activation not in _ACT:
        raise ValueError(f"fused_ffn: activation {activation!r}")
    D = x.shape[-1]
    FF = w1.shape[0]
    if w1.shape != (FF, D) or w2.shape != (D, FF) or b1.shape != (FF,) \
            or b2.shape != (D,) or D % 64 or FF % 64:
        raise ValueError(f"fused_ffn: shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} w2 {tuple(w2.shape)}; D and FF "
                         "must be multiples of 64")
    rows = x.numel() // D
    if rows == 0:
        return torch.empty_like(x)
    # weights in the input dtype, biases in f32 (as the Pallas kernel adds
    # them to its f32 accumulator); no copy when already so
    xc = x.contiguous()
    w1c = w1.to(x.dtype).contiguous()
    w2c = w2.to(x.dtype).contiguous()
    b1c = b1.float().contiguous()
    b2c = b2.float().contiguous()
    out = torch.empty_like(xc)
    ws = torch.empty((FF // 64, rows, D), dtype=torch.float32,
                     device=x.device)
    err = _launch()(xc.data_ptr(), w1c.data_ptr(), b1c.data_ptr(),
                    w2c.data_ptr(), b2c.data_ptr(), out.data_ptr(),
                    ws.data_ptr(), rows, D, FF, _ACT[activation],
                    _build.DTYPE_CODE[x.dtype], _build.stream_ptr(x))
    _build.check(err, "fused_ffn")
    _build.count_launch("fused_ffn")
    return out
