"""Top-k and top-p thresholds: kernel K4 (``csrc/topk.cu``), its plain
version, and the plain top-p search.

Replaces ``eamg_tpu/ops/topk.py::kth_value_pallas`` (and matches its XLA
twin ``kth_value_bitsearch``, which the JAX sampler runs). Both searches
find a threshold by 32 most-significant-bit-first passes over the
order-preserving uint32 key of each f32 logit:

    key(x) = bits(x) | 0x80000000   if x >= 0
             ~bits(x)               if x <  0

The plain versions hold the keys as int64 tensors, so every step is exact
and the results are bit-equal to the JAX functions.
"""

from __future__ import annotations

import functools

import torch

from . import _build

_SIGN = 0x80000000
_REST = 0x7FFFFFFF
_M = 0xFFFFFFFF


def _float_to_key(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32).to(torch.int64) & _M
    return torch.where(bits >= _SIGN, bits ^ _M, bits | _SIGN)


def _key_to_float(t: torch.Tensor) -> torch.Tensor:
    bits = torch.where(t >= _SIGN, t & _REST, t ^ _M)
    bits = torch.where(bits >= _SIGN, bits - (1 << 32), bits)  # to int32
    return bits.to(torch.int32).view(torch.float32)


def _radix_search(keys: torch.Tensor, predicate) -> torch.Tensor:
    """[B, V] keys -> [B, 1]: the largest t with ``predicate(keys >= t)``
    (monotone non-increasing in t), most significant bit first."""
    t = torch.zeros((keys.shape[0], 1), dtype=torch.int64,
                    device=keys.device)
    for bit in range(31, -1, -1):
        cand = t | (1 << bit)
        t = torch.where(predicate(keys >= cand), cand, t)
    return t


def kth_value_plain(logits: torch.Tensor, k: int) -> torch.Tensor:
    """[B, V] -> [B, 1] exact k-th largest value per row, in the logits'
    dtype (``kth_value_bitsearch``)."""
    keys = _float_to_key(logits)
    t = _radix_search(keys, lambda m: m.sum(-1, keepdim=True) >= k)
    return _key_to_float(t).to(logits.dtype)


def top_p_threshold(logits: torch.Tensor, p) -> torch.Tensor:
    """[B, V] -> [B, 1] nucleus threshold: the largest value t with
    ``sum(softmax(logits)[logits >= t]) >= p``
    (``top_p_threshold_bitsearch``; an XLA-only function in the JAX
    package, so plain here too). ``p`` a float or a [B, 1] tensor."""
    x = logits.float()
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    probs = e / e.sum(dim=-1, keepdim=True)
    keys = _float_to_key(x)
    p = torch.clamp(torch.as_tensor(p, dtype=torch.float32,
                                    device=x.device), min=1e-30)
    t = _radix_search(
        keys, lambda m: torch.where(m, probs, 0.0).sum(-1, keepdim=True)
        >= p)
    out = torch.where(t == 0, torch.tensor(float("-inf"), device=x.device),
                      _key_to_float(t))
    return out.to(logits.dtype)


@functools.cache
def _launch():
    P, I = _build.P, _build.I
    return _build.bind("topk", "eamg_kth_value", [P, P, I, I, I, P])


def kth_value(logits: torch.Tensor, k: int) -> torch.Tensor:
    """[B, V] -> [B, 1] exact k-th largest value per row, 0 < k <= V.
    CPU tensors take :func:`kth_value_plain`; CUDA tensors launch K4 (on
    the logits as f32, the result cast back, like the Pallas wrapper)."""
    if logits.device.type == "cpu":
        return kth_value_plain(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"kth_value: unsupported device {logits.device}")
    if logits.dim() != 2 or not 0 < k <= logits.shape[1] \
            or logits.shape[0] == 0:
        raise ValueError(f"kth_value: logits {tuple(logits.shape)}, k {k}")
    B, V = logits.shape
    if V * 4 > 220 * 1024:
        raise ValueError(f"kth_value: V={V} does not fit one block's "
                         "shared memory")
    x = logits.float().contiguous()
    out = torch.empty((B, 1), dtype=torch.float32, device=x.device)
    err = _launch()(x.data_ptr(), out.data_ptr(), B, V, int(k),
                    _build.stream_ptr(x))
    _build.check(err, "kth_value")
    _build.count_launch("kth_value")
    return out.to(logits.dtype)
