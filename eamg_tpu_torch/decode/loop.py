"""KV-cache generation: prefill, then one ``decode_step`` per token.

Port of ``eamg_tpu/decode/loop.py::generate_kv``. The JAX package runs the
loop as one compiled ``while_loop``; here it is a host loop over device
work, with at most one host sync per step (the EOS check, when an EOS id
is tracked). The same quirks hold:

- ``refeed_last_prompt=True`` (the reference's sample_kvcache) discards the
  warm-up logits; the first step re-feeds the last prompt token, so it is
  written into the cache a second time, at slot ``prompt_len``;
- an EOS is written before its row stops; later slots of a finished row
  hold ``pad_id``;
- the per-step keys come from ``split`` of the running key, or with
  ``presplit_keys`` from one ``split(key, max_len)``, indexed by position.

Random draws need no device data, so the Gumbel noise of many steps is
drawn in one batch ahead of the steps that use it.
"""

from __future__ import annotations

import torch

from ..models.gpt import GPTConfig, decode_step, init_kv_cache, prefill
from ..utils import prng
from .sampling import sample_token

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


@torch.no_grad()
def generate_kv(params: dict, prompt: torch.Tensor, prompt_len: int, rng,
                cfg: GPTConfig, max_len: int, temperature: float = 1.0,
                top_k: int = 50, eos_id: int = -1, pad_id: int = 0,
                greedy: bool = False, refeed_last_prompt: bool = True,
                mask_value: float = -1e10, presplit_keys: bool = False,
                top_p: float = 1.0, min_p: float = 0.0):
    """prompt [B, P] (padded to a bucket P, on the params' device),
    prompt_len real tokens in every row, rng a ``prng.PRNGKey``.
    Returns (tokens [B, max_len] int64 on the device, n_tokens int); slots
    at or past n_tokens hold pad_id."""
    B, P = prompt.shape
    assert cfg.pos_broadcast_bug or max_len <= cfg.n_pos, (
        f"max_len={max_len} exceeds the positional table "
        f"(n_pos={cfg.n_pos}); cap decode length at cfg.n_pos")
    dev = prompt.device
    cache = init_kv_cache(cfg, B, max_len, device=dev)
    logits0, cache = prefill(params, prompt, cfg, cache,
                             prompt_len=prompt_len)

    buf = torch.full((B, max_len), pad_id, dtype=torch.int64, device=dev)
    buf[:, :prompt_len] = prompt[:, :prompt_len]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    if refeed_last_prompt:
        last = prompt[:, prompt_len - 1].to(torch.int64)
        pos0 = prompt_len
        rng0 = rng
    else:
        rng0, sub = prng.split(rng)
        first = sample_token(sub, logits0[:, prompt_len - 1], temperature,
                             top_k, mask_value, greedy, top_p, min_p)
        buf[:, prompt_len] = first
        done = first == eos_id
        last = first
        pos0 = prompt_len + 1

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
        logits, cache = decode_step(params, last[:, None], cache, cfg)
        nxt = sample_token(None, logits, temperature, top_k, mask_value,
                           greedy, top_p, min_p,
                           gumbel=None if greedy else noise[i % NOISE_CHUNK])
        if track_eos:
            buf[:, pos] = torch.where(done, pad_id, nxt)
            done = done | (nxt == eos_id)
        else:
            buf[:, pos] = nxt
        last = nxt
        pos += 1
    return buf, pos
