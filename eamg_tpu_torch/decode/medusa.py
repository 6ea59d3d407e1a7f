"""Medusa decoding: ``gamma`` heads propose the tokens after the next one
from the hidden state the base head reads, and one block forward verifies
them.

Port of ``eamg_tpu/decode/medusa.py``. Per head a residual block ``h +
silu(W h + b)`` feeds the base LM head (Medusa-1); the heads are evaluated
stacked, one batched product for all of them. The verify loop and its
acceptance are the speculative decoders' (``decode/speculative.py``:
Leviathan's, with the head distributions as q), so sampled output follows
the base model's distribution and greedy output equals the plain greedy
decode. As in JAX, round 1 proposes from a zero hidden state, and a
sampled iteration splits the running key once (the proposal) and then in
three (acceptance and residual).

``generate_medusa`` (JAX: one ``while_loop`` program) and the stream
(``medusa_stream_start`` then ``medusa_stream_chunk`` a chunk of
``k_verifies`` iterations; ``stream_tokens_medusa``) run the same chunk
graph over the same state, so a stream gives the one-shot's tokens for any
sampling mode. ``init_medusa_heads`` makes zero heads (each starts as a
copy of the base head), which ``tools/medusa.py`` trains; the tree verify
is ``decode/medusa_tree.py`` and the engine's Medusa rows
``serve/continuous.py``.
"""

from __future__ import annotations

import torch

from ..models.gpt import GPTConfig, _head
from ..utils import prng
from . import graphs
from .speculative import (K_VERIFIES, SpecLoop, _padded_prompt, run_to_end,
                          spec_state)


def init_medusa_heads(rng, cfg: GPTConfig, n_heads: int) -> dict:
    """{"blocks": [{"w": [D, D], "b": [D]}, ...]} of f32 zeros on the CPU,
    so head k starts as the base next-token head (``rng`` is unused, as in
    JAX)."""
    D = cfg.d_model
    return {"blocks": [{"w": torch.zeros((D, D), dtype=torch.float32),
                        "b": torch.zeros((D,), dtype=torch.float32)}
                       for _ in range(n_heads)]}


def _stack_heads(heads: dict, gamma: int | None = None, device=None):
    """The first ``gamma`` heads' blocks -> (w [g, D, D], b [g, D]) f32 on
    ``device``: one batched product for all heads."""
    blocks = heads["blocks"][:gamma]
    return (torch.stack([torch.as_tensor(b["w"]) for b in blocks]).to(
                device, torch.float32),
            torch.stack([torch.as_tensor(b["b"]) for b in blocks]).to(
                device, torch.float32))


def _head_logits(w: torch.Tensor, b: torch.Tensor, params: dict,
                 h: torch.Tensor) -> torch.Tensor:
    """Stacked heads on one hidden state: h [D] -> [g, V] f32 (the f32
    heads promote the hidden state to f32, as JAX's einsum does)."""
    h32 = h.float()
    return _head(params, h32[None] + torch.nn.functional.silu(
        torch.einsum("gde,e->gd", w, h32) + b))


def medusa_logits(heads: dict, params: dict, h: torch.Tensor) -> torch.Tensor:
    """h [..., D] -> [n_heads, ..., V]: head k's logits for the token k + 2
    positions after the one ``h`` sits at (the base head covers + 1)."""
    w, b = _stack_heads(heads, device=h.device)
    h32 = h.float()
    z = torch.einsum("gde,...e->g...d", w, h32) \
        + b.reshape((b.shape[0],) + (1,) * (h.dim() - 1) + (-1,))
    return _head(params, h32[None] + torch.nn.functional.silu(z))


@torch.no_grad()
def generate_medusa(params: dict, heads: dict, prompt: torch.Tensor,
                    prompt_len: int, rng, cfg: GPTConfig, max_len: int,
                    gamma: int = 4, temperature: float = 1.0,
                    top_k: int = 50, eos_id: int = -1, pad_id: int = 0,
                    greedy: bool = False, top_p: float = 1.0,
                    min_p: float = 0.0, eager: bool = False):
    """prompt [1, P] (a bucket, on the params' device), ``rng`` a
    ``prng.PRNGKey`` -> (tokens [1, max_len] int64 on the host, n_tokens,
    n_verify_steps). ``gamma`` heads (at most as many as ``heads`` has)
    propose a verify step's tokens; (n_tokens - prompt_len) /
    n_verify_steps is the speculation's gain. ``eager=True`` issues every
    iteration from the host instead of replaying graphs, to compare."""
    assert len(heads["blocks"]) >= gamma >= 1
    assert prompt.shape[0] == 1, \
        "medusa decoding is a batch-1 latency optimization"
    key, make = spec_state(params, cfg, "medusa", max_len, gamma,
                           K_VERIFIES, top_k, greedy, top_p, min_p, eos_id,
                           pad_id, prompt.device, heads=heads, eager=eager)
    with graphs.pooled(key, make) as st:
        return run_to_end(st, prompt, prompt_len, rng, temperature, top_p,
                          min_p)


@torch.no_grad()
def medusa_stream_start(st: SpecLoop, prompt: torch.Tensor, prompt_len: int,
                        rng, temperature: float = 1.0, top_p: float = 1.0,
                        min_p: float = 0.0) -> int:
    """The stream's prelude on the state ``st``: prefill and the first
    token (JAX's ``_medusa_init``) -> the first token."""
    with graphs.on_stream(st.stream):
        st.start(prompt, prompt_len, rng, temperature, top_p, min_p)
        return int(st.last.item())


@torch.no_grad()
def medusa_stream_chunk(st: SpecLoop):
    """Up to ``k_verifies`` verify iterations (none once the request has
    ended) -> the packed [slack + 2] host copy: the buffer row, pos, done."""
    with graphs.on_stream(st.stream):
        return st.run_chunk()


@torch.no_grad()
def stream_tokens_medusa(params: dict, heads: dict, cfg: GPTConfig,
                         prompt_ids: list[int], max_len: int,
                         k_verifies: int = K_VERIFIES, gamma: int = 4,
                         temperature: float = 1.0, top_k: int = 50,
                         eos_id: int = -1, pad_id: int = 0,
                         greedy: bool = False, seed: int = 0,
                         bucket: int = 64, top_p: float = 1.0,
                         min_p: float = 0.0, eager: bool = False):
    """Python generator of token ids one at a time (batch 1): the first
    from the prefill, the rest every ``k_verifies`` verify iterations, each
    chunk one replay of the state's graph. The tokens are
    :func:`generate_medusa`'s for the same seed, whatever the bucket. The
    stream holds a state of its own while its consumer reads
    (``graphs.pooled``)."""
    assert cfg.causal and not cfg.pos_broadcast_bug
    gamma = min(gamma, len(heads["blocks"]))
    assert gamma >= 1
    max_len = min(max_len, cfg.n_pos - gamma)
    p = len(prompt_ids)
    if p >= max_len:
        return
    width = max(bucket, 1)
    while width < p:
        width *= 2
    width = min(width, max_len)
    dev = params["tok_emb"].device
    key, make = spec_state(params, cfg, "medusa", max_len, gamma, k_verifies,
                           top_k, greedy, top_p, min_p, eos_id, pad_id, dev,
                           heads=heads, eager=eager)
    with graphs.pooled(key, make) as st:
        first = medusa_stream_start(
            st, _padded_prompt(prompt_ids, width, pad_id, dev), p,
            prng.PRNGKey(seed), temperature, top_p, min_p)
        yield first
        if first == eos_id:
            return
        emitted, done = p + 1, False
        while emitted < max_len and not done:
            packed = medusa_stream_chunk(st)
            pos = min(int(packed[-2]), max_len)
            done = bool(packed[-1])
            for t in packed[emitted:pos]:
                yield int(t)
                if int(t) == eos_id:
                    return
            emitted = max(emitted, pos)
