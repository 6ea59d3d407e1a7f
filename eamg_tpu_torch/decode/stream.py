"""Streaming generation: the decode in chunks of steps, tokens on the host
after every chunk.

Port of ``eamg_tpu/decode/stream.py``. The one-shot loop
(``decode/loop.py``) hands the host nothing until the request is done. For
interactive serving (progress, early cancellation) the decode runs here as
a sequence of ``chunk``-step programs over a cache carried between them:
one program a chunk, the chunk's tokens on the host after it.

JAX jits each chunk as a ``lax.scan`` keyed by its ``static_argnames``.
Here a chunk is one block of the solo loop (``loop.SoloLoop`` with a block
of ``chunk`` steps), one replay of a CUDA graph over a decode state on the
device, keyed by the same things (batch, ``max_len``, ``chunk``,
``top_k``, greedy, which filters are on, the n-gram size); the chunk's
tokens come back in one copy, one host wait a chunk. On the CPU the same
block runs eagerly. A stream holds a state of its own while its consumer
reads it (``graphs.pooled``), so two streams of one key never wait for
each other.

JAX's semantics, kept here:
- the prompt bucket starts at ``bucket`` (64) and doubles until the
  prompt fits, capped at ``max_len``;
- the cache holds ``max_len + chunk`` slots, so the last, partial chunk
  may run past ``max_len``: those tokens are dropped;
- the first token is sampled from the prefill logits with one split of the
  seed's key (no refeed of the last prompt token), then every step of a
  chunk splits the running key once;
- a finished row emits PAD; the penalties' counts, the n-gram history
  (JAX's ``(buf, pos)``) and the grammar's state with its budget (JAX's
  ``grammar_state``: ``max_len - prompt_len`` for the first token, one
  less a step, which is ``max_len - pos`` on the loop's position) are
  carried between chunks in the pooled state.

A greedy stream equals ``generate_kv(..., refeed_last_prompt=False)``; a
sampled one is reproducible by its seed but is not the one-shot loop's
stream (another bucket, first-token rule and key chain).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gpt import GPTConfig
from ..utils import prng
from . import graphs
from .loop import _begin, _blocks, solo_state


@torch.no_grad()
def stream_tokens(params: dict, cfg: GPTConfig, prompt_ids: list[int],
                  max_len: int, chunk: int = 32, temperature: float = 1.0,
                  top_k: int = 50, eos_id: int = -1, pad_id: int = 0,
                  greedy: bool = False, seed: int = 0, bucket: int = 64,
                  top_p: float = 1.0, min_p: float = 0.0,
                  penalties: tuple | None = None, no_repeat_ngram: int = 0,
                  grammar=None, attn_impl: str = "sp", eager: bool = False,
                  capture_error_mode: str = "thread_local"):
    """Python generator of token ids one at a time (batch 1), on the
    params' device. The first comes from the prefill logits; the rest
    arrive ``chunk`` at a time, each chunk one replay of its graph on the
    card (``eager=True`` issues its steps from the host instead, to
    compare). ``grammar``: a ``decode.grammar.Grammar`` (or its
    ``arrays``) or None."""
    p = len(prompt_ids)
    if p >= max_len:
        # no slot left to generate into (reference: zero loop iterations)
        return
    width = max(bucket, 1)
    while width < p:
        width *= 2
    width = min(width, max_len)
    dev = params["tok_emb"].device
    prompt = np.full((1, width), pad_id, np.int64)
    prompt[0, :p] = prompt_ids
    key, make = solo_state(params, cfg, 1, max_len, dev, attn_impl, top_k,
                           greedy, -1e10, eos_id, pad_id, top_p, min_p,
                           penalties, no_repeat_ngram, chunk,
                           slots=max_len + chunk, eager=eager,
                           capture_error_mode=capture_error_mode,
                           grammar=grammar)
    with graphs.pooled(key, make) as st:
        with graphs.on_stream(st.stream):
            pos0, keys = _begin(st, torch.from_numpy(prompt).to(dev), p,
                                prng.PRNGKey(seed), temperature, top_p,
                                min_p, penalties, refeed=False,
                                presplit=False)
            tok = int(st.buf[0, p])
        yield tok
        if tok == eos_id:
            return
        blocks = _blocks(st, pos0, keys, emit=True)
        while True:
            with graphs.on_stream(st.stream):
                host = next(blocks, None)
            if host is None:
                return
            for t in host[0, :-1]:
                yield int(t)
                if t == eos_id:
                    return
