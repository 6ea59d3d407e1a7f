"""Beam search: K hypotheses as the batch rows of the cached decode.

Port of ``eamg_tpu/decode/beam.py``. The prompt is prefilled once at
batch 1 and its cache repeated to the K rows; each step is
``decode_step`` at batch K (K3 at B = K), a log-softmax in JAX's order,
finished beams collapsed to one PAD continuation at log-probability 0,
and the top K of the flattened [K * V] candidates, the lower index first
among equal values as ``lax.top_k`` orders them. Every per-beam state,
the cache rows among them, is reordered by the parent index
(``index_select`` into the same buffers). The ranking by ``score /
gen_len ** length_penalty`` is on the host (:func:`rank_beams`).

With a ``grammar`` (``decode/grammar.py``) each beam carries its own FSM
state: the prompt's, stepped by each beam's first token, then gathered by
parent and stepped by the chosen token every step. The mask goes on the
logits before the log-softmax, so the scores renormalize over the
continuations the grammar allows, as in JAX.

JAX runs the search as one ``while_loop`` that stops at ``max_len`` or
once every beam is done. Here blocks of steps replay one CUDA graph over a
state on the device, and a step past that stop changes nothing: it would
reorder the finished beams by score, so its writes are all masked. No
randomness is involved.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gpt import GPTConfig, decode_step, init_kv_cache, prefill
from . import graphs
from .grammar import (grammar_mask, grammar_step, grammar_tables,
                      scan_prompt_state)

_NEG = -1e30     # candidate mask: must dominate any real log-prob sum
_LOW = 0xFFFFFFFF


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_softmax`` in its order: (x - max) - log(sum(exp(x -
    max)))."""
    shifted = x - x.max(dim=-1, keepdim=True).values
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def top_k_ordered(x: torch.Tensor, k: int):
    """[N] f32 -> (the k largest values, their indices), ``lax.top_k``'s
    order: descending, the lower index first among equal values. Each
    value and its index make one int64 key (the value's order-preserving
    32 bits above the complement of the index), so every key is distinct
    and the library's selection cannot order ties either way."""
    from ..ops.topk import _float_to_key

    idx = torch.arange(x.shape[0], device=x.device)
    keys = ((_float_to_key(x) - (1 << 31)) << 32) | (_LOW - idx)
    top = torch.topk(keys, k).values
    sel = _LOW - (top & _LOW)
    return x.index_select(0, sel), sel


class BeamLoop:
    """The state on the device of one beam search for one graph key:
    ``cache`` (head-major, K rows, ``max_len`` slots), ``buf`` [K,
    max_len + 1] (the last column is a step past the end's, dropped),
    ``pos`` [1], ``last``, ``done``, ``gen_len`` [K], ``scores`` [K] f32,
    with a grammar its tables ``gram`` and the beams' states ``gstate``
    [K], and the graph of a block of steps."""

    def __init__(self, params: dict, cfg: GPTConfig, n_beams: int,
                 max_len: int, eos_id: int, pad_id: int, device,
                 gram: dict | None = None, block: int = graphs.BLOCK,
                 eager: bool = False):
        dev = torch.device(device)
        K = n_beams
        self.params, self.cfg, self.K, self.gram = params, cfg, K, gram
        self.max_len, self.eos_id, self.pad_id = max_len, eos_id, pad_id
        self.block = block
        self.stream = graphs.side_stream(dev)
        self.cache = init_kv_cache(cfg, K, max_len, device=dev)
        self.cache1 = init_kv_cache(cfg, 1, max_len, device=dev)
        self.buf = torch.zeros((K, max_len + 1), dtype=torch.int64,
                               device=dev)
        self.pos = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.last = torch.zeros((K,), dtype=torch.int64, device=dev)
        self.done = torch.zeros((K,), dtype=torch.bool, device=dev)
        self.gen_len = torch.zeros((K,), dtype=torch.int64, device=dev)
        self.scores = torch.zeros((K,), dtype=torch.float32, device=dev)
        self.gstate = None if gram is None else torch.zeros(
            (K,), dtype=torch.int64, device=dev)
        self._rows = torch.arange(K, device=dev)
        self._pad = torch.where(torch.arange(cfg.vocab_size, device=dev)
                                == pad_id, 0.0, _NEG)
        self.graph = graphs.BlockGraph(self._block, dev, eager)

    def running(self) -> torch.Tensor:
        """[1] bool: JAX's loop predicate."""
        run = self.pos < self.max_len
        if self.eos_id >= 0:
            run = run & ~self.done.all()
        return run

    def start(self, prompt: torch.Tensor, prompt_len: int) -> None:
        st, K = self, self.K
        P = prompt.shape[1]
        logits0, _ = prefill(st.params, prompt, st.cfg, st.cache1,
                             prompt_len=prompt_len)
        for name in ("k", "v"):
            for dst, src in zip(st.cache[name], st.cache1[name]):
                dst.copy_(src.expand_as(dst))
        st.cache["length"].copy_(st.cache1["length"])
        last_logits = logits0[:, prompt_len - 1]               # [1, V]
        if st.gram is not None:
            gstate1 = scan_prompt_state(st.gram, prompt, prompt_len)
            last_logits = grammar_mask(last_logits, gstate1, st.gram,
                                       budget_left=st.max_len - prompt_len)
        scores, first = top_k_ordered(log_softmax(last_logits[0]), K)
        if st.gram is not None:
            st.gstate.copy_(grammar_step(gstate1.expand(K), first, st.gram))
        real = torch.arange(P, device=prompt.device) < prompt_len
        st.buf.fill_(st.pad_id)
        st.buf[:, :P] = torch.where(real, prompt[0], st.pad_id)
        st.buf[:, prompt_len] = first
        st.done.copy_(first == st.eos_id if st.eos_id >= 0
                      else torch.zeros_like(st.done))
        st.last.copy_(first)
        st.scores.copy_(scores)
        st.gen_len.fill_(1)
        st.pos.fill_(prompt_len + 1)

    def _block(self) -> None:
        for _ in range(self.block):
            self._step()

    def _step(self) -> None:
        st, K = self, self.K
        V = st.cfg.vocab_size
        run = st.running()
        logits, _ = decode_step(st.params, st.last[:, None], st.cache,
                                st.cfg)
        if st.gram is not None:
            # before the softmax: the scores renormalize over the
            # continuations the grammar allows
            logits = grammar_mask(logits, st.gstate, st.gram,
                                  budget_left=st.max_len - st.pos)
        logp = log_softmax(logits)                           # [K, V]
        # a finished beam's one candidate: PAD at log-probability 0
        step = torch.where(st.done[:, None], st._pad, logp)
        new_scores, idx = top_k_ordered((st.scores[:, None] + step).reshape(
            -1), K)
        parent = torch.where(run, idx // V, st._rows)
        tok = idx % V
        for name in ("k", "v"):
            for c in st.cache[name]:
                c.copy_(c.index_select(0, parent))
        pdone = st.done.index_select(0, parent)
        pgen = st.gen_len.index_select(0, parent)
        plast = st.last.index_select(0, parent)
        buf = st.buf.index_select(0, parent)
        write = torch.where(pdone, st.pad_id, tok)
        col = st.pos.clamp(max=st.max_len)
        old = buf.index_select(1, col)[:, 0]
        buf.index_copy_(1, col, torch.where(run, write, old)[:, None])
        st.buf.copy_(buf)
        done = pdone | (tok == st.eos_id) if st.eos_id >= 0 else pdone
        st.done.copy_(torch.where(run, done, pdone))
        st.gen_len.copy_(torch.where(run, pgen + (~pdone).long(), pgen))
        st.last.copy_(torch.where(run, torch.where(pdone, plast, tok),
                                  plast))
        st.scores.copy_(torch.where(run, new_scores, st.scores))
        if st.gram is not None:
            stepped = grammar_step(st.gstate.index_select(0, parent), tok,
                                   st.gram, active=~pdone)
            st.gstate.copy_(torch.where(run, stepped, st.gstate))
        st.pos.add_(run.long())


def beam_state(params: dict, cfg: GPTConfig, n_beams: int, max_len: int,
               eos_id: int, pad_id: int, device, eager: bool = False,
               grammar=None) -> tuple:
    """-> (the graph key of a :class:`BeamLoop`, a function that makes
    one), keyed as JAX's ``static_argnames``: cfg, max_len, K, eos, pad,
    and the grammar's tables (by identity: the graph reads them by
    address)."""
    args = (cfg, int(n_beams), int(max_len), int(eos_id), int(pad_id),
            torch.device(device))
    gram = grammar_tables(grammar, device)
    key = ("beam", id(params), *args, bool(eager),
           None if gram is None else id(gram))
    return key, lambda: BeamLoop(params, *args, gram=gram, eager=eager)


@torch.no_grad()
def generate_beam(params: dict, prompt: torch.Tensor, prompt_len: int,
                  cfg: GPTConfig, max_len: int, n_beams: int = 4,
                  eos_id: int = -1, pad_id: int = 0,
                  length_penalty: float = 1.0, grammar=None,
                  eager: bool = False):
    """prompt [1, P] (a bucket, on the params' device) -> (buf [K,
    max_len], gen_lens [K], scores [K]) as numpy, unsorted: each row the
    prompt and its hypothesis (PAD-padded), the generated tokens (EOS
    included) and the summed log-probabilities. Rank with
    :func:`rank_beams` (``length_penalty`` is the ranking's, unused here,
    as in JAX). ``eos_id < 0`` runs every beam to ``max_len``.
    ``grammar``: a ``decode.grammar.Grammar`` (or its ``arrays``) or None:
    each beam constrained by its own FSM state."""
    assert prompt.shape[0] == 1, \
        "beam search expands ONE prompt into K hypotheses"
    assert cfg.pos_broadcast_bug or max_len <= cfg.n_pos, (
        f"max_len={max_len} exceeds the positional table "
        f"(n_pos={cfg.n_pos})")
    key, make = beam_state(params, cfg, n_beams, max_len, eos_id, pad_id,
                           prompt.device, eager, grammar)
    with graphs.pooled(key, make) as st, graphs.on_stream(st.stream):
        st.start(prompt, prompt_len)
        n_blocks = -(-(max_len - prompt_len - 1) // st.block)
        for _ in range(max(n_blocks, 0)):
            if not bool(st.running().item()):
                break
            st.graph.run()
        return (st.buf[:, :max_len].cpu().numpy(),
                st.gen_len.cpu().numpy(), st.scores.cpu().numpy())


def rank_beams(buf, gen_lens, scores, length_penalty: float = 1.0):
    """Host-side GNMT-style ranking: beams ordered by ``score /
    gen_len ** length_penalty``, descending (stable) -> (buf, gen_lens,
    scores, normalized), all reordered. length_penalty 0 ranks by the raw
    sum, 1 by the mean log-probability a token, > 1 favours longer."""
    buf = np.asarray(buf)
    gen_lens = np.asarray(gen_lens)
    scores = np.asarray(scores)
    norm = scores / np.maximum(gen_lens, 1) ** float(length_penalty)
    order = np.argsort(-norm, kind="stable")
    return buf[order], gen_lens[order], scores[order], norm[order]

