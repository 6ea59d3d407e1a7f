"""Teacher-forced decode: replay verification and perplexity.

Port of ``eamg_tpu/decode/replay.py``:
- ``teacher_forced_logits`` replays recorded ids the way the serving
  decode produced them: ``prefill`` then one cached ``decode_step`` a
  token (on the card: K1, K2 and K3);
- ``verify_stream`` replays a recorded stream and reports whether every
  token lies inside the sampler's filtered support, with its log-prob;
- ``perplexity`` is the paper's PPL over teacher-forced padded rows, in
  chunks of ``batch`` rows through ``forward`` (K1 and K2 on the card), the
  tail chunk padded with PAD rows, which the mask drops.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.gpt import (GPTConfig, decode_step, forward, init_kv_cache,
                          prefill)
from .sampling import apply_min_p, apply_top_k, apply_top_p


def _on(params: dict) -> torch.device:
    return params["tok_emb"].device


@torch.no_grad()
def teacher_forced_logits(params: dict, ids, prompt_len: int,
                          cfg: GPTConfig,
                          refeed_last_prompt: bool = True) -> torch.Tensor:
    """[B, L] recorded ids -> [B, L-P, V] f32 logits, one per generated
    token, computed as the serving decode computes them (prefill, then
    incremental steps, with the refeed/pos quirks as configured)."""
    dev = _on(params)
    ids = torch.as_tensor(np.asarray(ids, np.int64)).to(dev)
    B, L = ids.shape
    cache = init_kv_cache(cfg, B, L + 1, device=dev)
    logits0, cache = prefill(params, ids, cfg, cache, prompt_len=prompt_len)
    if refeed_last_prompt:
        # feed ids[P-1], ..., ids[L-2]; logits align with ids[P], ...
        start, steps = prompt_len - 1, L - prompt_len
    else:
        start, steps = prompt_len, L - 1 - prompt_len
    out = []
    for i in range(steps):
        logits, cache = decode_step(params, ids[:, start + i:start + i + 1],
                                    cache, cfg)
        out.append(logits)
    step_logits = torch.stack(out, dim=1) if out else \
        logits0.new_zeros((B, 0, logits0.shape[-1]))
    if refeed_last_prompt:
        return step_logits
    # the first target's logits come from the prefill's last prompt slot
    return torch.cat([logits0[:, prompt_len - 1:prompt_len], step_logits],
                     dim=1)


@torch.no_grad()
def verify_stream(params: dict, cfg: GPTConfig, ids, prompt_len: int,
                  temperature: float = 1.0, top_k: int = 50,
                  mask_value: float = -1e10,
                  refeed_last_prompt: bool = True,
                  top_p: float = 1.0, min_p: float = 0.0) -> dict:
    """Replay a recorded stream ([L] or [B, L], prompt included) -> its
    reachability and per-token log-probs under the filtered sampling
    distribution (pass the top_p / min_p it was sampled with)."""
    ids = np.atleast_2d(np.asarray(ids, np.int64))
    B, L = ids.shape
    logits = teacher_forced_logits(params, ids, prompt_len, cfg,
                                   refeed_last_prompt=refeed_last_prompt)
    n_gen = L - prompt_len
    logits = logits[:, :n_gen]
    V = logits.shape[-1]
    targets = torch.as_tensor(ids[:, prompt_len:]).to(logits.device)
    flat = (logits / temperature).reshape(-1, V)
    masked = apply_top_k(flat, top_k, mask_value)
    masked = apply_top_p(masked, top_p, mask_value)
    masked = apply_min_p(masked, min_p, mask_value)
    logp = torch.log_softmax(masked, dim=-1).reshape(B, n_gen, V)
    tok_logp = torch.gather(logp, -1, targets[..., None])[..., 0]
    in_support = tok_logp > math.log(1e-30)
    return {
        "n_tokens": int(n_gen) * B,
        "all_in_top_k": bool(in_support.all()),
        "in_top_k_fraction": float(in_support.float().mean()),
        "log_prob_per_token": tok_logp.cpu().numpy(),
        "total_log_prob": float(tok_logp.sum()),
    }


@torch.no_grad()
def perplexity(params: dict, cfg: GPTConfig, ids, pad_id: int = 0,
               batch: int = 128) -> float:
    """Teacher-forced next-token perplexity over [N, T] padded rows (x =
    ids[:, :-1], y = ids[:, 1:], PAD masked), ``batch`` rows at a time;
    a short tail chunk after the first is padded with PAD rows to keep one
    shape."""
    dev = _on(params)
    ids = np.asarray(ids, np.int64)
    total_nll, total_count = 0.0, 0
    for s in range(0, ids.shape[0], batch):
        chunk = ids[s:s + batch]
        if chunk.shape[0] < batch and s > 0:
            pad = np.full((batch - chunk.shape[0], ids.shape[1]), pad_id,
                          np.int64)
            chunk = np.concatenate([chunk, pad])
        chunk = torch.from_numpy(chunk).to(dev)
        x, y = chunk[:, :-1], chunk[:, 1:]
        logp = torch.log_softmax(forward(params, x, cfg).float(), dim=-1)
        nll = -torch.gather(logp, -1, y[..., None])[..., 0]
        mask = y != pad_id
        total_nll += float((nll * mask).sum())
        total_count += int(mask.sum())
    return float(np.exp(total_nll / max(total_count, 1)))
