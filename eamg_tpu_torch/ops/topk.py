"""Top-k and top-p thresholds: kernel K4 (``csrc/topk.cu``) with its two
entry points, the threshold (:func:`kth_value`) and the sampler's top-k
mask (:func:`top_k_mask`), their plain versions, and the plain top-p
search.

Replaces ``eamg_tpu/ops/topk.py::kth_value_pallas`` (and matches its XLA
twin ``kth_value_bitsearch``, which the JAX sampler runs). Both searches
find a threshold by 32 most-significant-bit-first passes over the
order-preserving uint32 key of each f32 logit (K4 finds the same key in
four passes of an 8-bit digit; the source note says why it is the same):

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
    out = torch.where(t == 0, float("-inf"), _key_to_float(t))
    return out.to(logits.dtype)


# the longest row K4 takes: its element offsets are int32
MAX_V = 1 << 30


def top_k_mask_plain(logits: torch.Tensor, k: int,
                     mask_value: float = -1e10) -> torch.Tensor:
    """[B, V] -> [B, V]: logits + (0 where a logit >= its row's k-th
    largest, ``mask_value`` elsewhere): JAX's ``apply_top_k`` for
    0 < k < V, the three ops of the sampler."""
    return _masked(logits, kth_value_plain(logits, k), mask_value)


def _masked(logits, thresh, mask_value):
    return logits + torch.where(logits >= thresh, 0.0, mask_value)


@functools.cache
def _launch(entry: str):
    P, I, F = _build.P, _build.I, _build.F
    args = {"eamg_kth_value": [P, P, I, I, I, P],
            "eamg_top_k_mask": [P, P, I, I, I, F, P]}[entry]
    return _build.bind("topk", entry, args)


def _check(what: str, logits: torch.Tensor, k: int) -> None:
    _build.require_cuda(what, logits)
    if logits.dim() != 2 or logits.shape[0] == 0 \
            or not 0 < logits.shape[1] <= MAX_V:
        raise ValueError(f"{what}: logits {tuple(logits.shape)}: [B, V] with "
                         f"B > 0 and 0 < V <= {MAX_V}")
    if not logits.dtype.is_floating_point:
        raise ValueError(f"{what}: logits of dtype {logits.dtype}")
    if not 0 < k <= logits.shape[1]:
        raise ValueError(f"{what}: k {k} outside 1..{logits.shape[1]}")


def kth_value(logits: torch.Tensor, k: int) -> torch.Tensor:
    """[B, V] -> [B, 1] exact k-th largest value per row, 0 < k <= V.
    CPU tensors take :func:`kth_value_plain`; CUDA tensors launch K4 (on
    the logits as f32, the result cast back, like the Pallas wrapper)."""
    _build.refuse_grad("kth_value", logits)
    if logits.device.type == "cpu":
        return kth_value_plain(logits, k)
    _check("kth_value", logits, k)
    B, V = logits.shape
    x = logits.float().contiguous()
    out = torch.empty((B, 1), dtype=torch.float32, device=x.device)
    err = _launch("eamg_kth_value")(x.data_ptr(), out.data_ptr(), B, V,
                                    int(k), _build.stream_ptr(x))
    _build.check(err, "kth_value")
    _build.count_launch("kth_value")
    return out.to(logits.dtype)


def top_k_mask(logits: torch.Tensor, k: int,
               mask_value: float = -1e10) -> torch.Tensor:
    """[B, V] -> [B, V] f32 :func:`top_k_mask_plain`, 0 < k <= V, for f32,
    bf16 or f16 logits. CPU tensors take the plain version; CUDA tensors
    one launch of K4 that selects the threshold and writes the masked
    logits, the 16-bit ones on their f32 copy: widening is exact, and the
    plain version's compare and add give the same f32 result."""
    _build.refuse_grad("top_k_mask", logits)
    if logits.device.type == "cpu":
        return top_k_mask_plain(logits, k, mask_value)
    _check("top_k_mask", logits, k)
    if logits.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"top_k_mask: logits of dtype {logits.dtype}")
    B, V = logits.shape
    x = logits.float().contiguous()
    out = torch.empty_like(x)
    err = _launch("eamg_top_k_mask")(x.data_ptr(), out.data_ptr(), B, V,
                                     int(k), float(mask_value),
                                     _build.stream_ptr(x))
    _build.check(err, "top_k_mask")
    _build.count_launch("top_k_mask")
    return out
