"""Fused FFN: kernel K2 (``csrc/ffn.cu``) and its plain version.

Replaces ``eamg_tpu/ops/ffn.py::fused_ffn``:
``act(x @ w1^T + b1) @ w2^T + b2`` with torch-layout weights, the
``[rows, FF]`` intermediate kept out of device memory. Both the kernel and
the plain version round in the Pallas kernel's order or in the JAX
model's ``kernels="xla"`` order (:func:`ffn_plain`), as the caller names.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from . import _build

_ACT = {"relu": 0, "gelu": 1}
# where the FFN rounds (ffn_plain): the launch flag of K2
ORDER = {"pallas": 0, "xla": 1}
FS = 16          # FF columns of a slice: FS in csrc/ffn.cu
PANEL_MAX = 512  # elements of D staged at once, at most: PANEL_MAX there


def _gelu_as_xla(h: torch.Tensor) -> torch.Tensor:
    """Exact gelu of h as XLA computes ``jax.nn.gelu(h, approximate=False)``
    in h's dtype: ``0.5 h * erfc(-h * c)`` with the constant c = sqrt(1/2)
    rounded to that dtype, erfc in f32 rounded to it, the product rounded
    (in f32: the gelu of f32)."""
    dt = h.dtype
    c = torch.tensor(math.sqrt(0.5), dtype=dt).item()
    e = torch.special.erfc(-h.float() * c).to(dt).float()
    return ((0.5 * h.float()) * e).to(dt)


def ffn_plain(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, activation: str = "relu",
              order: str = "pallas") -> torch.Tensor:
    """The FFN with weights cast to the input dtype and products
    accumulated in f32, rounded where ``order`` says:

    - ``"pallas"``, the Pallas kernel's: + b1 in f32, activation (exact
      gelu), h rounded to the input dtype, second product, + b2 in f32,
      one rounding of the output;
    - ``"xla"``, the JAX model's ``_linear`` -> act -> ``_linear``
      (``kernels="xla"``, which every shipped demo serves): each product
      rounded to the input dtype, + its bias rounded to that dtype (the sum
      rounded again), the activation on that value as JAX computes it in
      that dtype (:func:`_gelu_as_xla`), rounded.

    In f32 the two are one function."""
    if order not in ORDER:
        raise ValueError(f"fused_ffn: order {order!r}; want one of "
                         f"{tuple(ORDER)}")
    dt = x.dtype
    if order == "xla":
        h = (x.float() @ w1.to(dt).float().T).to(dt)
        h = (h.float() + b1.to(dt).float()).to(dt)
        h = _gelu_as_xla(h) if activation == "gelu" else torch.relu(h)
        out = (h.float() @ w2.to(dt).float().T).to(dt)
        return (out.float() + b2.to(dt).float()).to(dt)
    h = x.float() @ w1.to(dt).float().T + b1.float()
    h = F.gelu(h) if activation == "gelu" else torch.relu(h)
    out = h.to(dt).float() @ w2.to(dt).float().T + b2.float()
    return out.to(dt)


@dataclasses.dataclass(frozen=True)
class FFNPlan:
    """How K2 cuts an FFN of width D and FF: the FF columns of phase 1's
    ``slices`` ([start, stop), in order; a block takes slices b, b + G,
    ...), D staged in panels of ``panel`` elements, and
    ``scratch_per_row`` elements (x's dtype) of scratch for each row: its
    h, read back by every block in phase 2."""
    slices: tuple
    panel: int
    scratch_per_row: int


@functools.cache
def ffn_plan(D: int, FF: int) -> FFNPlan:
    """The plan of K2 for D and FF (multiples of 64). It takes no rows: the
    slices, the panels and every order of the kernel's sums follow from D
    and FF alone, so a row gets the same bits alone and inside a batch."""
    if D <= 0 or FF <= 0 or D % 64 or FF % 64:
        raise ValueError(f"fused_ffn: D {D}, FF {FF}: both must be positive "
                         "multiples of 64")
    slices = tuple((f, f + FS) for f in range(0, FF, FS))
    panel = max(p for p in range(64, min(D, PANEL_MAX) + 1, 64) if D % p == 0)
    return FFNPlan(slices, panel, FF)


def check_args(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
               w2: torch.Tensor, b2: torch.Tensor,
               activation: str) -> FFNPlan:
    """What K2 takes, checked on any device -> its plan: x [..., D] of
    float32 or bfloat16 (weights of another dtype are cast to x's, biases
    of another dtype to float32, by the wrapper); D and FF multiples of 64;
    relu or gelu. Raises ValueError on the rest."""
    if x.dtype not in _build.DTYPE_CODE:
        raise ValueError(f"fused_ffn: dtype {x.dtype}; want float32 or "
                         "bfloat16")
    if activation not in _ACT:
        raise ValueError(f"fused_ffn: activation {activation!r}; want relu "
                         "or gelu")
    D, FF = x.shape[-1], w1.shape[0]
    if w1.shape != (FF, D) or w2.shape != (D, FF) or b1.shape != (FF,) \
            or b2.shape != (D,):
        raise ValueError(f"fused_ffn: shapes x {tuple(x.shape)} w1 "
                         f"{tuple(w1.shape)} b1 {tuple(b1.shape)} w2 "
                         f"{tuple(w2.shape)} b2 {tuple(b2.shape)}")
    return ffn_plan(D, FF)


@functools.cache
def _launch():
    P, I = _build.P, _build.I
    return _build.bind("ffn", "eamg_fused_ffn",
                       [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
              w2: torch.Tensor, b2: torch.Tensor, activation: str = "relu",
              order: str = "pallas") -> torch.Tensor:
    """x [..., D], w1 [FF, D], b1 [FF], w2 [D, FF], b2 [D] -> [..., D],
    rounded where ``order`` says (:func:`ffn_plain`). CPU tensors take
    :func:`ffn_plain`; CUDA tensors launch K2, one cooperative launch
    (:func:`check_args` says what it takes). Refuses inputs that require
    grad while autograd records."""
    _build.refuse_grad("fused_ffn", x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return ffn_plain(x, w1, b1, w2, b2, activation, order)
    if x.device.type != "cuda":
        raise ValueError(f"fused_ffn: unsupported device {x.device}")
    plan = check_args(x, w1, b1, w2, b2, activation)
    if order not in ORDER:
        raise ValueError(f"fused_ffn: order {order!r}; want one of "
                         f"{tuple(ORDER)}")
    D = x.shape[-1]
    rows = x.numel() // D
    if rows == 0:
        return torch.empty_like(x)
    xc = _aligned(x)
    w1c = _aligned(w1.to(x.dtype))
    w2c = _aligned(w2.to(x.dtype))
    # the kernel reads both biases in x's dtype or both in f32
    b1c, b2c = b1, b2
    if b1.dtype != x.dtype or b2.dtype != x.dtype:
        b1c, b2c = b1.float(), b2.float()
    b1c, b2c = _aligned(b1c), _aligned(b2c)
    out = torch.empty_like(xc)
    hbuf = torch.empty(plan.scratch_per_row * rows, dtype=x.dtype,
                       device=x.device)
    err = _launch()(xc.data_ptr(), w1c.data_ptr(), b1c.data_ptr(),
                    w2c.data_ptr(), b2c.data_ptr(), out.data_ptr(),
                    hbuf.data_ptr(), rows, D, w1.shape[0], plan.panel,
                    _ACT[activation], ORDER[order],
                    int(b1c.dtype == torch.float32 and x.dtype
                        != torch.float32),
                    _build.DTYPE_CODE[x.dtype], _build.stream_ptr(x))
    _build.check(err, "fused_ffn")
    _build.count_launch("fused_ffn")
    return out
