"""Sampling: penalties, temperature, top-k, top-p, min-p, then a
categorical draw.

Port of ``eamg_tpu/decode/sampling.py``: ``sample_token`` with its
transforms in the same order (penalties on the raw logits, then
temperature, top-k, top-p, min-p) and with the same additive mask
(``mask_value`` on filtered tokens), and the anti-repetition controls the
decode loops keep state for: ``token_counts``, ``apply_penalties``,
``no_repeat_ngram_ban`` and ``apply_no_repeat_ngram``. The draw is
``jax.random.categorical``'s Gumbel-max: ``argmax(gumbel + logits)``, with
the Gumbel noise from the threefry port (``utils/prng.py``), so a seeded
stream matches the JAX package token for token.

``sample_rows`` is the row-batched form the ragged decode and the
continuous engine use (``decode/ragged.py::_sample_per_row`` and
``serve/continuous.py::_sample_rows`` in the JAX package, which vmap
``sample_token`` over the rows): one temperature per row and, in per-row
mode, one top-p and one min-p per row, with all rows' thresholds found by
one launch each, and the penalties first: batch-wide values (the window
batcher groups requests by them) or, in the engine's per-row mode, one set
a row over the rows' own counts. Grammar constraints are in
``decode/grammar.py``; the loops apply them after the n-gram ban and
before the sampler.
"""

from __future__ import annotations

import torch

from ..ops.topk import top_k_mask, top_p_threshold
from ..utils import prng


def apply_top_k(logits: torch.Tensor, top_k: int,
                mask_value: float = -1e10) -> torch.Tensor:
    """logits + (0 where logit >= the k-th largest, mask_value elsewhere);
    ties at the threshold are kept. On the card, f32 logits take one
    launch of K4 (``ops/topk.py::top_k_mask``)."""
    if top_k is None or top_k <= 0 or top_k >= logits.shape[-1]:
        return logits
    return top_k_mask(logits, top_k, mask_value)


def apply_top_p(logits: torch.Tensor, top_p,
                mask_value: float = -1e10) -> torch.Tensor:
    """Nucleus filter; ``top_p`` >= 1 (or None) is an exact no-op. A tensor
    ``top_p`` (one value on the logits' device, or [B, 1]) is always
    applied: the decode loops pass the request's value so, filled once per
    request, which a CUDA graph can read."""
    if not isinstance(top_p, torch.Tensor):
        if top_p is None or float(top_p) >= 1.0:
            return logits
        top_p = float(top_p)
    thresh = top_p_threshold(logits, top_p)
    return logits + torch.where(logits >= thresh, 0.0, mask_value)


def log_min_p(min_p: float, device) -> torch.Tensor:
    """ln(min_p), min_p clamped to [1e-38, 1], as a [1] f32 tensor on
    ``device``: the min-p threshold's offset, computed on the host as
    :func:`apply_min_p` computes it, so a decode loop that makes it once per
    request keeps the same bits."""
    mp = torch.clamp(torch.tensor([float(min_p)], dtype=torch.float32),
                     1e-38, 1.0)
    return torch.log(mp).to(device)


def apply_min_p(logits: torch.Tensor, min_p: float,
                mask_value: float = -1e10,
                log_mp: torch.Tensor | None = None) -> torch.Tensor:
    """Keep tokens with logit >= max + ln(min_p); ``min_p`` <= 0 is an exact
    no-op and values above 1 are clamped to 1 (keeps the argmax). With
    ``log_mp`` (:func:`log_min_p`, on the logits' device) the filter is on
    and ``min_p`` is not read."""
    if log_mp is None:
        if min_p is None or float(min_p) <= 0.0:
            return logits
        log_mp = log_min_p(min_p, logits.device)
    thresh = logits.max(dim=-1, keepdim=True).values + log_mp
    return logits + torch.where(logits >= thresh, 0.0, mask_value)


def filter_logits(logits: torch.Tensor, temperature, top_k: int,
                  mask_value: float = -1e10, top_p=1.0, min_p: float = 0.0,
                  log_mp: torch.Tensor | None = None) -> torch.Tensor:
    """Temperature (a float, or a tensor on the logits' device), top-k,
    top-p and min-p, in the JAX sampler's order."""
    logits = logits / temperature
    logits = apply_top_k(logits, top_k, mask_value)
    logits = apply_top_p(logits, top_p, mask_value)
    return apply_min_p(logits, min_p, mask_value, log_mp)


def token_counts(ids: torch.Tensor, valid: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """[B, T] token ids + [B, T] validity mask -> [B, V] f32 occurrence
    counts (duplicate ids accumulate). Seeds the penalty state from the
    prompt, so the penalties see the prompt's tokens too."""
    counts = torch.zeros((ids.shape[0], vocab_size), dtype=torch.float32,
                         device=ids.device)
    return counts.scatter_add_(1, ids.long(), valid.to(torch.float32))


def count_tokens(counts: torch.Tensor, nxt: torch.Tensor,
                 active: torch.Tensor) -> torch.Tensor:
    """counts with one more occurrence of nxt[b] for every active row, in
    place (one index a row, so no two writes meet)."""
    counts[torch.arange(nxt.shape[0], device=nxt.device), nxt] += \
        active.to(torch.float32)
    return counts


def no_repeat_ngram_ban(buf: torch.Tensor, pos, n: int,
                        vocab_size: int) -> torch.Tensor:
    """[B, L] token history + its length ``pos`` (an int or [B]) -> [B, V]
    bool mask of the tokens that would complete an ``n``-gram already in
    ``buf[:, :pos]`` (HF ``no_repeat_ngram_size``): for every start j with
    j + n - 1 <= pos - 1, if ``buf[:, j:j+n-1]`` equals the last n - 1
    tokens of the history, ``buf[:, j+n-1]`` is banned. n = 1 bans every
    token seen."""
    B, L = buf.shape
    dev = buf.device
    pos = torch.as_tensor(pos, dtype=torch.int64, device=dev).expand(B)
    starts = torch.arange(L, device=dev)[None, :]
    # an earlier n-gram must end inside the history
    match = (starts <= pos[:, None] - n) & (pos[:, None] >= n)
    if n > 1:
        tail_idx = (pos[:, None] - (n - 1)
                    + torch.arange(n - 1, device=dev)[None, :]).clamp(0, L - 1)
        tail = torch.gather(buf, 1, tail_idx)                  # [B, n-1]
        for i in range(n - 1):
            # rows that the roll wraps around fail the bound above
            match &= torch.roll(buf, -i, dims=1) == tail[:, i:i + 1]
    banned_tok = torch.roll(buf, -(n - 1), dims=1) if n > 1 else buf
    hits = torch.zeros((B, vocab_size), dtype=torch.float32, device=dev)
    hits.scatter_add_(1, banned_tok.long(), match.to(torch.float32))
    return hits > 0.0


def apply_no_repeat_ngram(logits: torch.Tensor, buf: torch.Tensor, pos,
                          n: int, mask_value: float = -1e10,
                          row_on: torch.Tensor | None = None) -> torch.Tensor:
    """Additive n-gram ban on the raw logits (before temperature and the
    filters; it moves the greedy argmax too). n = 0 is off. ``row_on``
    ([B] bool) gates per row: a row off keeps its logits bit for bit (the
    engine's rows share one ban size)."""
    if not n:
        return logits
    ban = no_repeat_ngram_ban(buf, pos, n, logits.shape[-1])
    if row_on is not None:
        ban = ban & row_on[:, None]
    return logits + torch.where(ban, mask_value, 0.0)


def penalties_on(repetition_penalty, frequency_penalty,
                 presence_penalty) -> bool:
    def neutral(v, n):
        return v is None or float(v) == n
    return not (neutral(repetition_penalty, 1.0)
                and neutral(frequency_penalty, 0.0)
                and neutral(presence_penalty, 0.0))


def penalty_tensor(penalties, device) -> torch.Tensor | None:
    """(repetition, frequency, presence) -> a [3] f32 tensor on ``device``
    (the repetition penalty clamped to >= 1e-6, as :func:`apply_penalties`
    clamps it), or None when all three are neutral: what a decode loop
    makes once per request and passes as ``penalties``."""
    if penalties is None or not penalties_on(*penalties):
        return None
    rep, freq, pres = penalties
    return torch.tensor(
        [max(1.0 if rep is None else float(rep), 1e-6),
         0.0 if freq is None else float(freq),
         0.0 if pres is None else float(pres)],
        dtype=torch.float32).to(device)


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    repetition_penalty=1.0, frequency_penalty=0.0,
                    presence_penalty=0.0,
                    penalties: torch.Tensor | None = None) -> torch.Tensor:
    """Anti-repetition transforms of the raw logits over the occurrence
    ``counts`` ([B, V] f32, prompt + generated so far). Repetition penalty
    (CTRL / HF): a seen token's logit becomes ``logit / p`` if positive,
    else ``logit * p``, with p clamped to >= 1e-6. Frequency and presence
    penalties (OpenAI): ``logit -= freq * count + pres * (count > 0)``. The
    neutral values (1, 0, 0) change nothing, bit for bit. ``penalties``
    (:func:`penalty_tensor`) gives the three on the device instead, and is
    always applied."""
    if penalties is not None:
        rp, fp, pp = penalties[0:1], penalties[1:2], penalties[2:3]
    elif not penalties_on(repetition_penalty, frequency_penalty,
                          presence_penalty):
        return logits
    else:
        rp = max(1.0 if repetition_penalty is None
                 else float(repetition_penalty), 1e-6)
        fp = 0.0 if frequency_penalty is None else float(frequency_penalty)
        pp = 0.0 if presence_penalty is None else float(presence_penalty)
    return _penalize(logits, counts, rp, fp, pp)


def _penalize(logits, counts, rp, fp, pp) -> torch.Tensor:
    """The penalties' arithmetic in JAX's order; rp, fp and pp are floats
    or tensors that broadcast against the logits (rp clamped already)."""
    present = counts > 0.0
    penalized = torch.where(logits < 0.0, logits * rp, logits / rp)
    out = torch.where(present, penalized, logits)
    return out - fp * counts - pp * present.to(torch.float32)


def sample_token(key, logits: torch.Tensor, temperature, top_k: int,
                 mask_value: float = -1e10, greedy: bool = False,
                 top_p=1.0, min_p: float = 0.0,
                 gumbel: torch.Tensor | None = None,
                 counts: torch.Tensor | None = None,
                 repetition_penalty=1.0, frequency_penalty=0.0,
                 presence_penalty=0.0,
                 penalties: torch.Tensor | None = None,
                 log_mp: torch.Tensor | None = None) -> torch.Tensor:
    """[B, V] f32 logits -> [B] int64 token ids. With ``counts`` the three
    penalties apply to the raw logits first, in greedy mode too. ``gumbel``
    ([B, V]) may carry noise drawn ahead for ``key`` (the decode loop draws
    many steps at once); otherwise it is drawn here. ``temperature``,
    ``top_p``, ``penalties`` and ``log_mp`` may be tensors on the logits'
    device (the decode loops fill them once per request, so a CUDA graph
    of the step reads them there)."""
    if counts is not None:
        logits = apply_penalties(logits, counts, repetition_penalty,
                                 frequency_penalty, presence_penalty,
                                 penalties)
    if greedy:
        return torch.argmax(logits, dim=-1)
    logits = filter_logits(logits, temperature, top_k, mask_value, top_p,
                           min_p, log_mp)
    if gumbel is None:
        gumbel = prng.gumbel(key, logits.shape, logits.device)
    return torch.argmax(gumbel + logits, dim=-1)


def sample_rows(logits: torch.Tensor, temps: torch.Tensor, top_k: int,
                mask_value: float = -1e10, greedy: bool = False,
                top_p=1.0, min_p: float = 0.0,
                top_ps: torch.Tensor | None = None,
                min_ps: torch.Tensor | None = None,
                gumbel: torch.Tensor | None = None,
                log_mp: torch.Tensor | None = None,
                counts: torch.Tensor | None = None,
                penalties: torch.Tensor | None = None,
                rep_ps: torch.Tensor | None = None,
                freq_ps: torch.Tensor | None = None,
                pres_ps: torch.Tensor | None = None) -> torch.Tensor:
    """[B, V] f32 logits, temps [B] -> [B] int64 token ids, row b drawn
    with its own noise ``gumbel[b]`` ([B, V], from the rows' keys).

    With ``counts`` ([B, V]) the penalties apply to the raw logits first,
    in greedy mode too: ``penalties`` ([3], :func:`penalty_tensor`) for
    the whole batch, or ``rep_ps``/``freq_ps``/``pres_ps`` ([B]) a row
    (JAX's engine in per-row mode; a row at 1, 0, 0 keeps its logits bit
    for bit).

    ``top_p``/``min_p`` are batch-wide (``top_p`` a float, or a tensor on
    the device as :func:`apply_top_p` takes it; ``log_mp`` as
    :func:`apply_min_p` takes it). ``top_ps``/``min_ps`` ([B]) switch to
    per-row filtering instead: a row at 1.0 / 0.0 keeps its logits bit for
    bit (the filtered values are selected per row), so an unfiltered
    request samples what it would sample alone."""
    if counts is not None:
        if rep_ps is not None:
            logits = _penalize(logits, counts,
                               torch.clamp(rep_ps, min=1e-6)[:, None],
                               freq_ps[:, None], pres_ps[:, None])
        else:
            logits = apply_penalties(logits, counts, penalties=penalties)
    if greedy:
        return torch.argmax(logits, dim=-1)
    logits = logits / temps[:, None]
    logits = apply_top_k(logits, top_k, mask_value)
    if top_ps is None:
        logits = apply_top_p(logits, top_p, mask_value)
        logits = apply_min_p(logits, min_p, mask_value, log_mp)
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
