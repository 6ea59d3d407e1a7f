"""Sampling: temperature, top-k, top-p, min-p, then a categorical draw.

Port of ``eamg_tpu/decode/sampling.py::sample_token`` for its filters, in
the same order (temperature, top-k, top-p, min-p) and with the same
additive mask (``mask_value`` on filtered tokens). The draw is
``jax.random.categorical``'s Gumbel-max: ``argmax(gumbel + logits)``, with
the Gumbel noise from the threefry port (``utils/prng.py``), so a seeded
stream matches the JAX package token for token.

``sample_rows`` is the row-batched form the ragged decode and the
continuous engine use (``decode/ragged.py::_sample_per_row`` and
``serve/continuous.py::_sample_rows`` in the JAX package, which vmap
``sample_token`` over the rows): one temperature per row and, in per-row
mode, one top-p and one min-p per row, with all rows' thresholds found by
one launch each.

Penalties, n-gram bans and grammar constraints are not in the port yet.
"""

from __future__ import annotations

import torch

from ..ops.topk import kth_value, top_p_threshold
from ..utils import prng


def apply_top_k(logits: torch.Tensor, top_k: int,
                mask_value: float = -1e10) -> torch.Tensor:
    """logits + (0 where logit >= the k-th largest, mask_value elsewhere);
    ties at the threshold are kept."""
    if top_k is None or top_k <= 0 or top_k >= logits.shape[-1]:
        return logits
    thresh = kth_value(logits, top_k)
    return logits + torch.where(logits >= thresh, 0.0, mask_value)


def apply_top_p(logits: torch.Tensor, top_p: float,
                mask_value: float = -1e10) -> torch.Tensor:
    """Nucleus filter; ``top_p`` >= 1 (or None) is an exact no-op."""
    if top_p is None or float(top_p) >= 1.0:
        return logits
    thresh = top_p_threshold(logits, float(top_p))
    return logits + torch.where(logits >= thresh, 0.0, mask_value)


def apply_min_p(logits: torch.Tensor, min_p: float,
                mask_value: float = -1e10) -> torch.Tensor:
    """Keep tokens with logit >= max + ln(min_p); ``min_p`` <= 0 is an exact
    no-op and values above 1 are clamped to 1 (keeps the argmax)."""
    if min_p is None or float(min_p) <= 0.0:
        return logits
    mp = torch.clamp(torch.tensor(float(min_p), dtype=torch.float32),
                     1e-38, 1.0)
    thresh = logits.max(dim=-1, keepdim=True).values + torch.log(mp).to(
        logits.device)
    return logits + torch.where(logits >= thresh, 0.0, mask_value)


def filter_logits(logits: torch.Tensor, temperature: float, top_k: int,
                  mask_value: float = -1e10, top_p: float = 1.0,
                  min_p: float = 0.0) -> torch.Tensor:
    logits = logits / temperature
    logits = apply_top_k(logits, top_k, mask_value)
    logits = apply_top_p(logits, top_p, mask_value)
    return apply_min_p(logits, min_p, mask_value)


def sample_token(key, logits: torch.Tensor, temperature: float, top_k: int,
                 mask_value: float = -1e10, greedy: bool = False,
                 top_p: float = 1.0, min_p: float = 0.0,
                 gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """[B, V] f32 logits -> [B] int64 token ids. ``gumbel`` ([B, V]) may
    carry noise drawn ahead for ``key`` (the decode loop draws many steps
    at once); otherwise it is drawn here."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits, temperature, top_k, mask_value, top_p,
                           min_p)
    if gumbel is None:
        gumbel = prng.gumbel(key, logits.shape, logits.device)
    return torch.argmax(gumbel + logits, dim=-1)


def sample_rows(logits: torch.Tensor, temps: torch.Tensor, top_k: int,
                mask_value: float = -1e10, greedy: bool = False,
                top_p: float = 1.0, min_p: float = 0.0,
                top_ps: torch.Tensor | None = None,
                min_ps: torch.Tensor | None = None,
                gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """[B, V] f32 logits, temps [B] -> [B] int64 token ids, row b drawn
    with its own noise ``gumbel[b]`` ([B, V], from the rows' keys).

    ``top_p``/``min_p`` are batch-wide floats. ``top_ps``/``min_ps`` ([B])
    switch to per-row filtering instead: a row at 1.0 / 0.0 keeps its
    logits bit for bit (the filtered values are selected per row), so an
    unfiltered request samples what it would sample alone."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits / temps[:, None]
    logits = apply_top_k(logits, top_k, mask_value)
    if top_ps is None:
        logits = apply_top_p(logits, top_p, mask_value)
        logits = apply_min_p(logits, min_p, mask_value)
    else:
        pp = top_ps[:, None]
        thresh = top_p_threshold(logits, pp)
        masked = logits + torch.where(logits >= thresh, 0.0, mask_value)
        logits = torch.where(pp < 1.0, masked, logits)
        mp = (min_ps if min_ps is not None
              else torch.zeros_like(top_ps))[:, None]
        thresh = (logits.max(dim=-1, keepdim=True).values
                  + torch.log(torch.clamp(mp, 1e-38, 1.0)))
        masked = logits + torch.where(logits >= thresh, 0.0, mask_value)
        logits = torch.where(mp > 0.0, masked, logits)
    return torch.argmax(gumbel + logits, dim=-1)
