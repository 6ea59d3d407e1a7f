"""Generation loops: ``generate_kv`` (prefill, then one ``decode_step``
per token) and ``generate_full`` (the uncached loop over ``forward``).

Port of ``eamg_tpu/decode/loop.py``. The JAX package runs each loop as one
compiled ``while_loop``; here it is a host loop over device work, for any
batch of rows of one prompt length, with at most one host sync per step
(the EOS check, when an EOS id is tracked). ``attn_impl`` names the decode
attention kernel and with it the cache layout (``models/gpt.py``); every
one gives the same stream in f32. The same quirks hold:

- ``refeed_last_prompt=True`` (the reference's sample_kvcache) discards the
  warm-up logits; the first step re-feeds the last prompt token, so it is
  written into the cache a second time, at slot ``prompt_len``;
- an EOS is written before its row stops; later slots of a finished row
  hold ``pad_id``;
- the per-step keys come from ``split`` of the running key, or with
  ``presplit_keys`` from one ``split(key, max_len)``, indexed by position;
- ``penalties`` count the prompt's tokens too, and a finished row's counts
  stop; ``no_repeat_ngram`` bans on the raw logits, on the warm-up logits
  too when ``refeed_last_prompt=False``. Both act in greedy mode as well.

Random draws need no device data, so the Gumbel noise of many steps is
drawn in one batch ahead of the steps that use it.
"""

from __future__ import annotations

import torch

from ..models.gpt import (GPTConfig, cache_layout, decode_step,
                          forward_masked, init_kv_cache, prefill)
from ..utils import prng
from .sampling import (apply_no_repeat_ngram, penalties_on, sample_token,
                       token_counts)

NOISE_CHUNK = 64   # steps of Gumbel noise drawn per batch


def _step_keys(rng, pos0: int, max_len: int, presplit: bool) -> list:
    """The sampling key of every step from pos0 to max_len - 1."""
    if presplit:
        return prng.split(rng, max_len)[pos0:]
    keys = []
    for _ in range(pos0, max_len):
        rng, sub = prng.split(rng)
        keys.append(sub)
    return keys


def _penalty_args(penalties) -> dict:
    """(repetition, frequency, presence) or None -> ``sample_token``'s
    penalty arguments; {} when all three are neutral (no counts are kept
    then)."""
    if penalties is None or not penalties_on(*penalties):
        return {}
    return dict(zip(("repetition_penalty", "frequency_penalty",
                     "presence_penalty"), penalties))


def _start(prompt: torch.Tensor, prompt_len: int, max_len: int, pad_id: int,
           vocab_size: int, pen: dict):
    """The token buffer with the prompt in it, and the prompt's counts
    when penalties are on."""
    B, P = prompt.shape
    dev = prompt.device
    real = torch.arange(P, device=dev)[None, :] < prompt_len
    buf = torch.full((B, max_len), pad_id, dtype=torch.int64, device=dev)
    buf[:, :P] = torch.where(real, prompt, pad_id)
    counts = token_counts(prompt, real.expand(B, P), vocab_size) \
        if pen else None
    return buf, counts


def _count(counts, nxt: torch.Tensor, active: torch.Tensor):
    """counts with one more occurrence of nxt[b] for every active row."""
    counts[torch.arange(nxt.shape[0], device=nxt.device), nxt] += \
        active.to(torch.float32)
    return counts


@torch.no_grad()
def generate_kv(params: dict, prompt: torch.Tensor, prompt_len: int, rng,
                cfg: GPTConfig, max_len: int, temperature: float = 1.0,
                top_k: int = 50, eos_id: int = -1, pad_id: int = 0,
                greedy: bool = False, refeed_last_prompt: bool = True,
                mask_value: float = -1e10, presplit_keys: bool = False,
                top_p: float = 1.0, min_p: float = 0.0,
                penalties: tuple | None = None, no_repeat_ngram: int = 0,
                attn_impl: str = "sp"):
    """prompt [B, P] (padded to a bucket P, on the params' device),
    prompt_len real tokens in every row, rng a ``prng.PRNGKey``.
    ``penalties``: (repetition, frequency, presence) or None;
    ``no_repeat_ngram``: the banned n-gram size, 0 for none; ``attn_impl``:
    one of ``models.gpt.ATTN_IMPLS``. Returns (tokens [B, max_len] int64
    on the device, n_tokens int); slots at or past n_tokens hold pad_id."""
    B, P = prompt.shape
    assert cfg.pos_broadcast_bug or max_len <= cfg.n_pos, (
        f"max_len={max_len} exceeds the positional table "
        f"(n_pos={cfg.n_pos}); cap decode length at cfg.n_pos")
    dev = prompt.device
    pen = _penalty_args(penalties)
    ngram = int(no_repeat_ngram or 0)
    cache = init_kv_cache(cfg, B, max_len, device=dev,
                          layout=cache_layout(attn_impl, cfg))
    logits0, cache = prefill(params, prompt, cfg, cache,
                             prompt_len=prompt_len)

    buf, counts = _start(prompt, prompt_len, max_len, pad_id, cfg.vocab_size,
                         pen)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    if refeed_last_prompt:
        last = prompt[:, prompt_len - 1].to(torch.int64)
        pos0 = prompt_len
        rng0 = rng
    else:
        rng0, sub = prng.split(rng)
        last_logits = apply_no_repeat_ngram(
            logits0[:, prompt_len - 1], buf, prompt_len, ngram, mask_value)
        first = sample_token(sub, last_logits, temperature, top_k,
                             mask_value, greedy, top_p, min_p, counts=counts,
                             **pen)
        buf[:, prompt_len] = first
        done = first == eos_id
        last = first
        pos0 = prompt_len + 1
        if pen:
            counts = _count(counts, first, torch.ones_like(done))

    track_eos = eos_id >= 0
    keys = [] if greedy else _step_keys(rng0, pos0, max_len, presplit_keys)
    noise = None
    pos = pos0
    while pos < max_len:
        if track_eos and bool(done.all()):
            break
        i = pos - pos0
        if not greedy and i % NOISE_CHUNK == 0:
            ks = keys[i:i + NOISE_CHUNK]
            noise = prng.gumbel(ks, (B, cfg.vocab_size), dev)
        logits, cache = decode_step(params, last[:, None], cache, cfg,
                                    attn_impl)
        logits = apply_no_repeat_ngram(logits, buf, pos, ngram, mask_value)
        nxt = sample_token(None, logits, temperature, top_k, mask_value,
                           greedy, top_p, min_p,
                           gumbel=None if greedy else noise[i % NOISE_CHUNK],
                           counts=counts, **pen)
        if pen:
            counts = _count(counts, nxt, ~done)
        if track_eos:
            buf[:, pos] = torch.where(done, pad_id, nxt)
            done = done | (nxt == eos_id)
        else:
            buf[:, pos] = nxt
        last = nxt
        pos += 1
    return buf, pos


@torch.no_grad()
def generate_full(params: dict, prompt: torch.Tensor, prompt_len: int, rng,
                  cfg: GPTConfig, max_len: int, temperature: float = 1.0,
                  top_k: int = 50, eos_id: int = -1, pad_id: int = 0,
                  greedy: bool = False, mask_value: float = -1e10,
                  top_p: float = 1.0, min_p: float = 0.0,
                  penalties: tuple | None = None, no_repeat_ngram: int = 0):
    """Uncached generation (the reference's ``sample()``): every step
    re-encodes the whole prefix through ``forward_masked`` at one shape,
    [B, max_len - 1] with the first ``pos`` positions valid. Arguments and
    result as :func:`generate_kv`; a key is split off every step, and the
    loop looks at the rows' done flags every step."""
    B = prompt.shape[0]
    T = max_len - 1   # the reference never re-encodes the final token
    pen = _penalty_args(penalties)
    ngram = int(no_repeat_ngram or 0)
    buf, counts = _start(prompt, prompt_len, max_len, pad_id, cfg.vocab_size,
                         pen)
    done = torch.zeros((B,), dtype=torch.bool, device=prompt.device)
    pos = prompt_len
    while pos < max_len and not bool(done.all()):
        rng, sub = prng.split(rng)
        logits = forward_masked(params, buf[:, :T], cfg, valid_len=pos)
        last_logits = apply_no_repeat_ngram(logits[:, pos - 1], buf, pos,
                                            ngram, mask_value)
        nxt = sample_token(sub, last_logits, temperature, top_k, mask_value,
                           greedy, top_p, min_p, counts=counts, **pen)
        if pen:
            counts = _count(counts, nxt, ~done)
        buf[:, pos] = torch.where(done, pad_id, nxt)
        done = done | (nxt == eos_id)
        pos += 1
    return buf, pos
