"""Ragged batched generation: per-row prompt lengths in one decode.

Port of ``eamg_tpu/decode/ragged.py``: each row carries its own length,
prefill masks per row, the cache tracks per-row lengths, a decode step
reads per-row positions and writes per-row cache slots, and rows finish
independently. Corrected causal configurations only. This is what the
window batcher and the continuous engine decode with.

The port's ragged cache is position-major and fused,
``{"kv": [n_layer x [B, M, 2 * KVD]], "lengths": [B] int32}``: a cache row
is the tail ``qkv[..., D:]`` of the fused QKV projection, so prefill
writes the prompt's rows straight into it and a decode step writes one
``[B, 2 * KVD]`` slice per layer with one indexed write, then attends
through the fold kernel (``ops/decode_fold.py``) with q and the result in
concat-heads order. Only prefill makes a ``[B, H, T, Dh]`` view, for K1.
The cache tensors are updated in place.

Each row's stream is a function of the parameters, its prompt and its key
alone. Per-row keys are advanced on the host (``utils/prng.py``), and the
Gumbel noise of up to ``NOISE_CHUNK`` steps is drawn in one batch; a step
itself never waits for the device. Penalties, n-gram bans and grammar
constraints are not in the port yet (``NotInPort``), nor is
``decode_block_ragged``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gpt import (GPTConfig, _embed, _head, decode_layers_fused,
                          prefill_fused)
from ..ops.decode_fold import fold_decode
from ..utils import prng
from ..utils.errors import NotInPort
from .sampling import sample_rows

NOISE_CHUNK = 64   # steps between two looks at the rows' done flags


def init_ragged_cache(cfg: GPTConfig, batch: int, max_len: int,
                      device=None) -> dict:
    shape = (batch, max_len, 2 * cfg.kv_dim)
    return {"kv": [torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                   for _ in range(cfg.n_layer)],
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


@torch.no_grad()
def prefill_ragged(params: dict, ids: torch.Tensor,
                   prompt_lens: torch.Tensor, cfg: GPTConfig, cache: dict):
    """[B, T] padded prompts with per-row lengths -> ([B, T, V] logits,
    cache). K/V of all T slots, pads included, go to the cache; keys at or
    past a row's length are masked."""
    assert cfg.causal and not cfg.pos_broadcast_bug
    valid = prompt_lens.to(device=ids.device, dtype=torch.int32)
    logits = prefill_fused(params, ids, valid, cfg, cache["kv"])
    return logits, {"kv": cache["kv"], "lengths": valid.clone()}


@torch.no_grad()
def decode_step_ragged(params: dict, last: torch.Tensor, cache: dict,
                       cfg: GPTConfig):
    """[B] last tokens at per-row positions t = lengths -> ([B, V] f32
    logits, cache with lengths + 1). The row's new K/V go to slot t[b]
    (positions past the end clamp to the last slot and the last position
    row, as XLA's dynamic slices do; such a row is finished)."""
    B = last.shape[0]
    t = cache["lengths"]
    M = cache["kv"][0].shape[1]
    slot = t.clamp(max=M - 1).long()
    pos_rows = params["pos"][t.clamp(max=params["pos"].shape[0] - 1).long()]
    x = _embed(params, last[:, None], pos_rows[:, None], cfg.torch_dtype)
    rows = torch.arange(B, device=last.device)
    x = decode_layers_fused(params, x, cache["kv"], (rows, slot), t, cfg,
                            fold_decode)
    return _head(params, x)[:, 0], {"kv": cache["kv"], "lengths": t + 1}


def draw_noise(sub_keys: np.ndarray, vocab_size: int, device) -> torch.Tensor:
    """Gumbel noise for sampling keys [..., 2] -> [..., V]: row by row what
    ``jax.random.categorical(key, logits[None])`` adds to its logits."""
    lead = sub_keys.shape[:-1]
    return prng.gumbel(sub_keys.reshape(-1, 2), (vocab_size,),
                       device).reshape(*lead, vocab_size)


@torch.no_grad()
def ragged_steps(params: dict, st: dict, cfg: GPTConfig, noise, *,
                 steps: int, top_k: int, greedy: bool, mask_value: float,
                 eos_id: int, pad_id: int, top_p: float = 1.0,
                 min_p: float = 0.0, per_row: bool = False) -> dict:
    """Advance every live row of ``st`` by ``steps`` decode steps, in place;
    done rows and rows at their budget are inert. ``noise`` is
    [steps, B, V] (None when greedy). Nothing here reads a value back from
    the device.

    ``st``: buf [B, M] int32, pos/row_max [B] int32, last [B] int64,
    done [B] bool, temps/top_ps/min_ps [B] f32, cache."""
    cols = torch.arange(st["buf"].shape[1], device=st["buf"].device)[None]
    for i in range(steps):
        cache = st["cache"]
        logits, new_cache = decode_step_ragged(params, st["last"], cache, cfg)
        nxt = sample_rows(logits, st["temps"], top_k, mask_value, greedy,
                          top_p, min_p,
                          st["top_ps"] if per_row else None,
                          st["min_ps"] if per_row else None,
                          None if greedy else noise[i])
        pos, done = st["pos"], st["done"]
        active = ~(done | (pos >= st["row_max"]))
        write = torch.where(active, nxt, pad_id).to(torch.int32)
        hit = (cols == pos[:, None]) & active[:, None]
        st["buf"] = torch.where(hit, write[:, None], st["buf"])
        # inactive rows must not advance their cache length
        st["cache"] = {"kv": new_cache["kv"],
                       "lengths": torch.where(active, new_cache["lengths"],
                                              cache["lengths"])}
        pos = torch.where(active, pos + 1, pos)
        st["pos"] = pos
        st["done"] = done | (active & (nxt == eos_id)) | (pos >= st["row_max"])
        st["last"] = torch.where(active, nxt, st["last"])
    return st


def _row_keys(rngs, batch: int) -> np.ndarray:
    """[B, 2] uint32 keys from per-row keys, or from one key fanned out
    with ``fold_in(key, row)``."""
    arr = np.asarray(rngs, dtype=np.uint32)
    if arr.ndim == 1:
        key = (int(arr[0]), int(arr[1]))
        arr = np.asarray([prng.fold_in(key, i) for i in range(batch)],
                         np.uint32)
    return arr


@torch.no_grad()
def generate_kv_ragged(params: dict, prompt: torch.Tensor, prompt_lens,
                       rngs, cfg: GPTConfig, max_len: int,
                       temperature: float = 1.0, top_k: int = 50,
                       eos_id: int = -1, pad_id: int = 0,
                       greedy: bool = False, mask_value: float = -1e10,
                       top_p: float = 1.0, min_p: float = 0.0,
                       penalties: tuple | None = None,
                       no_repeat_ngram: int = 0, grammar=None):
    """Heterogeneous batch: prompt [B, P] padded (on the params' device),
    prompt_lens [B] (host ints), one key per row (rngs [B, 2] uint32, what
    ``prng.key_rows(seeds)`` gives) or a single key, fanned out per row.
    Returns (tokens [B, max_len] int32, lengths [B] int32) on the device;
    row b holds its prompt then its generation, pad_id elsewhere."""
    for name, on in (("penalties", penalties is not None
                      and tuple(float(v) for v in penalties)
                      != (1.0, 0.0, 0.0)),
                     ("no_repeat_ngram", bool(no_repeat_ngram)),
                     ("grammar", grammar is not None)):
        if on:
            raise NotInPort(name)
    B, P = prompt.shape
    assert max_len <= cfg.n_pos, (
        f"max_len={max_len} exceeds the positional table "
        f"(n_pos={cfg.n_pos}); cap decode length at cfg.n_pos")
    dev = prompt.device
    V = cfg.vocab_size
    top_p = 1.0 if top_p is None else float(top_p)
    min_p = 0.0 if min_p is None else float(min_p)
    keys = _row_keys(rngs, B)
    plens_host = [int(v) for v in np.asarray(
        prompt_lens.cpu() if isinstance(prompt_lens, torch.Tensor)
        else prompt_lens)]
    plens = torch.tensor(plens_host, dtype=torch.int32, device=dev)
    cache = init_ragged_cache(cfg, B, max_len, device=dev)
    logits0, cache = prefill_ragged(params, prompt, plens, cfg, cache)

    cols = torch.arange(max_len, device=dev)[None]
    buf = torch.full((B, max_len), pad_id, dtype=torch.int32, device=dev)
    buf[:, :P] = torch.where(cols[:, :P] < plens[:, None], prompt, pad_id)
    temps = torch.full((B,), float(temperature), dtype=torch.float32,
                       device=dev)
    keys, subs = prng.split_rows(keys)
    last_logits = logits0[torch.arange(B, device=dev), (plens - 1).long()]
    first = sample_rows(last_logits, temps, top_k, mask_value, greedy, top_p,
                        min_p, gumbel=None if greedy
                        else draw_noise(subs, V, dev))
    # a row whose prompt fills the buffer starts done and keeps its last
    # prompt token
    active0 = plens < max_len
    hit0 = (cols == plens[:, None]) & active0[:, None]
    st = {"cache": cache,
          "buf": torch.where(hit0, first[:, None].to(torch.int32), buf),
          "pos": torch.where(active0, plens + 1, plens),
          "last": first,
          "done": (first == eos_id) | ~active0,
          "row_max": torch.full((B,), max_len, dtype=torch.int32,
                                device=dev),
          "temps": temps}
    left = max_len - 1 - min(plens_host)   # steps the shortest row can take
    while left > 0:
        if bool(st["done"].all()):         # one look per NOISE_CHUNK steps
            break
        n = min(NOISE_CHUNK, left)
        noise = None
        if not greedy:
            keys, subs = prng.split_rows_chain(keys, n)
            noise = draw_noise(subs, V, dev)
        ragged_steps(params, st, cfg, noise, steps=n, top_k=top_k,
                     greedy=greedy, mask_value=mask_value, eos_id=eos_id,
                     pad_id=pad_id, top_p=top_p, min_p=min_p)
        left -= n
    return st["buf"], torch.clamp(st["pos"], max=max_len)
