"""Continuous batching: requests join and leave a RUNNING ragged decode.

Port of ``eamg_tpu/serve/continuous.py``. The engine owns a persistent
device-resident decode state, a fixed pool of row slots over one shared
ragged KV cache (position-major and fused, ``decode/ragged.py``), and
advances it ``chunk`` steps at a time. Between chunks the host admits
queued requests into free slots (a per-row prefill writes the new row's
K/V into the shared cache) and harvests finished rows, so a request that
arrives mid-decode starts within about one chunk instead of one full
generation.

Correctness contract (tested): every row's token stream is the one the
same request gives alone through ``generate_kv_ragged``, whatever the
other rows do: per-row keys advance once per step, independent of batch
composition, admission timing and chunk boundaries, and the kernels under
the step give a row the same bits in any batch (``ops/decode_fold.py``).
``run_detached`` runs a lone request through the same functions on a
private state of the same shape.

No step waits for the device. A chunk is one replay of a CUDA graph of
its steps on the card (JAX's ``lax.scan`` of the chunk,
``decode/ragged.py::RaggedGraph``), over a state whose tensors keep their
addresses for its life. The worker issues chunk k+1 before it reads chunk
k's flags (depth-1 lookahead, so harvest lags completion by at most one
chunk), and each harvest is one packed fetch (``_pack_snapshot``: buffer,
positions and done flags in one tensor), copied without blocking into
pinned host memory and awaited through an event. The worker and the
detached decode issue on streams of their own.

Under a profiler session (``utils/logging.py``) every iteration of the
worker lies under one span: ``engine.wait_requests`` (blocked for want of
requests), ``engine.admit``, ``engine.chunk``, ``engine.harvest_wait``,
``engine.harvest``, or the ``engine.loop`` around them; a request's
``engine.queue`` runs from ``submit`` to its dequeue, its
``engine.join`` to when the card reaches its prefill. ``stats`` counts
``row_steps``, ``live_row_steps`` and ``row_tokens`` always.

``submit_stream`` is the streaming twin of ``submit``: the worker pushes a
row's new tokens at every harvest, and their concatenation is
``submit()``'s result less the prompt. A stream closed mid-way cancels its
row, which frees its slot at the next chunk boundary.

Row options, as in JAX: with ``per_row_sampling`` every row carries its
own top-p, min-p and penalties (with its counts); an engine built with
``no_repeat_ngram`` bans n-grams of that size in the rows that ask
(``ngram_on``), and one built with a ``grammar`` constrains the rows that
ask (``gstate``, ``gram_on``). A row that asks for nothing keeps its
logits bit for bit, so its stream is the default engine's.

An engine built with ``medusa_heads`` carries Medusa rows (``med_on``,
``h_last``): while one is live the worker runs the Medusa chunk
(:func:`medusa_chunk`, a second graph of ``chunk_med`` verify iterations)
instead of the plain one. A Medusa row is its solo Medusa decode: admitted
through the solo prefill, each iteration ``speculative.medusa_verify`` on
a head-major copy of its cache of the solo cache's size
(``decode/ragged.py::decode_block_ragged``'s rows), Leviathan's acceptance,
a multi-token masked write and the length rewind; plain rows in that
chunk sample from the block's first query with the plain chunk's keys and
transforms (on the CPU their tokens are the plain chunk's; on the card
another product may round a near tie the other way). The budget shrinks by
gamma, as in JAX.

On a model group (a ``Generator`` built with ``tp=``, one process a rank,
each holding its blocks, ``parallel/mesh.py::shard_params(tp=True)``),
the engine's state, admissions and chunks run on every rank with that
rank's heads, FF columns and cache (``decode/ragged.py``), and every
rank must make the same ``admit_row`` and ``ragged_chunk`` calls in the
same order, or their collectives would not pair. JAX has one controller
and GSPMD; the port has a plan. Rank 0 of the group leads: it owns the
queue, ``submit``, the harvest, cancellation and ``close``, and before
each iteration that admits a row or runs a chunk it broadcasts that
iteration's plan to the group as one int64 tensor (:class:`_PlanChannel`):
the admissions (slot, the prompt's ids, the key, the budget, the row's
temperature, its per-row sampling values and whether it is a Medusa
row), after which a chunk runs, and whether that chunk is the Medusa
chunk or the plain one; or "stop". The other ranks build the same engine
and call :meth:`ContinuousBatcher.serve_follower`, which applies each
plan as it comes and returns at "stop"; no request goes to them.

A fault on a group is met where it can be without waiting out
``parallel.multihost.TIMEOUT``:

- one in the leader's own work (the queue, the harvest, the plan) finds
  the followers waiting for a plan: the leader sends them "stop" (they
  return), fails its live, admitted and queued requests, and closes;
- one that a plan brings (a poisoned admission) raises at the same point
  on every rank, since every rank runs the same code on the same data:
  the followers' loops raise it, and the leader fails its requests and
  closes;
- one on a single rank inside an admission or a chunk leaves its peers
  inside a collective that no message can complete (neither gloo's nor
  NCCL's abort wakes a peer). A follower's ``serve_follower`` raises it,
  and its process is to exit: its connections close, the leader's
  collective raises at once, and the leader fails its requests and
  closes. A leader's own such fault leaves the followers to the
  collective's timeout.

Timing
never changes a row's stream: a row's tokens depend on the params, its
prompt and its key alone, and the plan exists only so that the
collectives match. On a group of more than one rank every step is issued
from the host (no collective inside a captured graph), the Medusa
chunk's too; a group of one keeps its graphs. The detached decode goes
through the engine there. Medusa rows verify on a scratch of the rank's
K/V heads, and their heads are whole on every rank: they act on the
hidden states after the sums, and their logits are gathered whole
(``decode/medusa.py``), so every rank draws the same tokens.
"""

from __future__ import annotations

import datetime
import itertools
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from ..decode import graphs
from ..decode.api import Generator, _bucket
from ..decode.grammar import (grammar_mask, grammar_step, grammar_tables,
                              scan_prompt_state)
from ..decode.ragged import (RaggedGraph, draw_noise, init_ragged_cache,
                             load_row, prefill_ragged, store_row,
                             verify_scratch)
from ..decode.sampling import (apply_min_p, apply_no_repeat_ngram,
                               apply_top_k, apply_top_p, count_tokens,
                               log_min_p, sample_rows, token_counts)
from ..decode.speculative import (_categorical_log, _dist, _softmax,
                                  medusa_verify)
from ..models.gpt import init_kv_cache, prefill
from ..utils import prng
from ..utils.device import bind_thread_to
from ..utils.logging import add_span, clock_ns, span

_NEUTRAL_PEN = (1.0, 0.0, 0.0)   # (repetition, frequency, presence) = off


class EngineOverloaded(RuntimeError):
    """Raised at submit time when the engine's admission queue is full. The
    HTTP layer maps it to 503 + Retry-After, so clients back off while the
    rows in flight keep their latency."""


def wait_for_worker(event: threading.Event, worker: threading.Thread,
                    timeout: float) -> bool:
    """``event.wait(timeout)``, but a worker thread that has died raises
    at once instead of leaving its clients to time out."""
    deadline = time.monotonic() + timeout
    while not event.wait(min(1.0, max(deadline - time.monotonic(), 0.0))):
        if not worker.is_alive():
            raise RuntimeError("the batching worker thread is not running")
        if time.monotonic() >= deadline:
            return False
    return True


def init_state(cfg, slots: int, max_len: int, device=None,
               per_row_sampling: bool = False, no_repeat_ngram: int = 0,
               grammar: bool = False, medusa: bool = False,
               tp=None) -> dict:
    """The engine's state; free slots start done with no budget. All of it
    lives on ``device`` but ``rngs``, the per-slot running keys ([slots, 2]
    uint32), which the host advances (``utils/prng.py``). Every tensor
    keeps its address for the state's life (admissions, chunks and
    :func:`reset_state` write into it), so the graph of its chunks stays
    valid. Per-row sampling adds the penalties' state (``counts`` [slots,
    V] and ``rep_ps``/``freq_ps``/``pres_ps``), an n-gram ban a row's
    on/off bit ``ngram_on``, a grammar the rows' FSM states ``gstate`` and
    their bit ``gram_on``, Medusa rows the hidden state a row's heads
    propose from ``h_last`` [slots, D] (zero at admission, as the solo
    decode starts) and the rows' bit ``med_on`` (with per-row sampling also
    ``log_mps``, a row's ln(min_p) made on the host as the solo decode
    makes it). Under ``tp`` the cache holds this rank's K/V heads."""
    def full(value, dtype):
        return torch.full((slots,), value, dtype=dtype, device=device)

    state = {
        "cache": init_ragged_cache(cfg, slots, max_len, device=device,
                                   tp=tp),
        "buf": torch.zeros((slots, max_len), dtype=torch.int32,
                           device=device),
        "pos": full(0, torch.int32),
        "last": full(0, torch.int64),
        "done": full(True, torch.bool),
        "rngs": np.zeros((slots, 2), np.uint32),
        "row_max": full(0, torch.int32),
        "temps": full(1.0, torch.float32),
        "top_ps": full(1.0, torch.float32),
        "min_ps": full(0.0, torch.float32),
    }
    if per_row_sampling:
        state["counts"] = torch.zeros((slots, cfg.vocab_size),
                                      dtype=torch.float32, device=device)
        state["rep_ps"] = full(1.0, torch.float32)
        state["freq_ps"] = full(0.0, torch.float32)
        state["pres_ps"] = full(0.0, torch.float32)
    if no_repeat_ngram:
        state["ngram_on"] = full(False, torch.bool)
    if grammar:
        state["gstate"] = full(0, torch.int64)
        state["gram_on"] = full(False, torch.bool)
    if medusa:
        state["h_last"] = torch.zeros((slots, cfg.d_model),
                                      dtype=cfg.torch_dtype, device=device)
        state["med_on"] = full(False, torch.bool)
        if per_row_sampling:
            state["log_mps"] = full(0.0, torch.float32)
    return state


# the neutral value of each optional per-slot field, for reset_state
_ROW_NEUTRAL = {"counts": 0.0, "rep_ps": 1.0, "freq_ps": 0.0,
                "pres_ps": 0.0, "ngram_on": False, "gstate": 0,
                "gram_on": False, "h_last": 0.0, "med_on": False,
                "log_mps": 0.0}


def reset_state(state: dict) -> dict:
    """Every slot free again, as :func:`init_state` leaves them, in place
    (the cache keeps its contents: an admission's prefill overwrites what
    its row reads)."""
    state["buf"].zero_()
    state["pos"].zero_()
    state["last"].zero_()
    state["done"].fill_(True)
    state["rngs"][:] = 0
    state["row_max"].zero_()
    state["temps"].fill_(1.0)
    state["top_ps"].fill_(1.0)
    state["min_ps"].zero_()
    state["cache"]["lengths"].zero_()
    for name, value in _ROW_NEUTRAL.items():
        if name in state:
            state[name].fill_(value)
    return state


@torch.no_grad()
def admit_row(params, state, prompt, plen: int, slot: int, key, rmax: int,
              temp: float, cfg, top_k=50, greedy=False, mask_value=-1e10,
              eos_id=-1, pad_id=0, top_p=1.0, row_top_p=1.0,
              per_row_sampling=False, row_min_p=0.0,
              row_penalties=_NEUTRAL_PEN, no_repeat_ngram=0,
              row_ngram_on=False, grammar=None, row_gram_on=False,
              medusa_row=False, tp=None) -> dict:
    """Prefill ONE request into slot ``slot`` of the running state, in
    place. prompt: [1, P] on the device (P a power-of-two bucket), ``key``
    a ``prng.PRNGKey``; ``plen``, ``slot`` and ``rmax`` are host ints.
    Reproduces ``generate_kv_ragged``'s start exactly: one key split, the
    first token sampled from the prefill logits and written at position
    plen. All P cache slots are written, pads included; decode overwrites
    them from plen on. In JAX's order the first token's logits take the
    row's n-gram ban over its prompt (``no_repeat_ngram``, when
    ``row_ngram_on``), its grammar's mask with ``rmax - plen`` tokens left
    (``grammar``: the engine's tables, when ``row_gram_on``) and, in
    per-row mode, its penalties over the prompt's counts; every per-slot
    field is written, so a reused slot keeps nothing of its last row.

    ``medusa_row`` starts the row as its solo Medusa decode starts
    (``SpecLoop.start``): the head-major prefill, whose K/V are copied into
    the shared cache, and the first token drawn as ``categorical(log(dist
    + 1e-30))`` of the filtered softmax; its ``h_last`` is zero.
    ``tp``: the model group, ``params`` this rank's blocks."""
    dev = prompt.device
    P = prompt.shape[1]
    max_len = state["buf"].shape[1]
    cache = state["cache"]
    if medusa_row:
        logits0 = _medusa_prefill(params, prompt, plen, slot, cfg, cache, tp)
    else:
        # the row's prefill writes straight into the shared cache
        row_cache = {"kv": [kv[slot:slot + 1] for kv in cache["kv"]]}
        logits0, _ = prefill_ragged(
            params, prompt, torch.tensor([plen], dtype=torch.int32,
                                         device=dev), cfg, row_cache, tp)
    cache["lengths"][slot] = plen

    rng_next, sub = prng.split(key)
    temps = torch.full((1,), float(temp), dtype=torch.float32, device=dev)
    last_logits = logits0[:, plen - 1]
    grammar = grammar_tables(grammar, dev)
    if no_repeat_ngram and row_ngram_on:
        last_logits = apply_no_repeat_ngram(last_logits, prompt, plen,
                                            no_repeat_ngram, mask_value)
    if grammar is not None:
        gs_row = scan_prompt_state(grammar, prompt, plen)        # [1]
        if row_gram_on:
            last_logits = grammar_mask(last_logits, gs_row, grammar,
                                       budget_left=rmax - plen)
    pen = {}
    if per_row_sampling:
        pen = dict(zip(("rep_ps", "freq_ps", "pres_ps"), (
            torch.full_like(temps, float(v)) for v in row_penalties)))
        pen["counts"] = token_counts(
            prompt, torch.arange(P, device=dev)[None] < plen, cfg.vocab_size)
    if medusa_row and greedy:
        first = torch.argmax(last_logits[0])
    elif medusa_row:
        dist = _medusa_filter(
            temps, top_k, top_p, per_row_sampling,
            torch.full_like(temps, float(row_top_p)),
            torch.full_like(temps, float(row_min_p)),
            log_min_p(row_min_p, dev))(last_logits)[0]
        first = _categorical_log(prng.gumbel(sub, dist.shape, dev), dist)
    else:
        first = sample_rows(
            last_logits, temps, top_k, mask_value, greedy, top_p, 0.0,
            torch.full_like(temps, float(row_top_p)) if per_row_sampling
            else None,
            torch.full_like(temps, float(row_min_p)) if per_row_sampling
            else None,
            None if greedy else draw_noise(np.asarray([sub], np.uint32),
                                           cfg.vocab_size, dev), **pen)[0]

    # buffer row: the prompt, then (when a slot remains) the first token;
    # a row with plen == rmax starts done and keeps its last prompt token
    active0 = plen < rmax
    row = torch.full((max_len,), pad_id, dtype=torch.int32, device=dev)
    row[:plen] = prompt[0, :plen]
    if active0:
        row[plen] = first
    state["buf"][slot] = row
    state["pos"][slot] = plen + 1 if active0 else plen
    state["last"][slot] = first
    state["done"][slot] = (first == eos_id) if active0 else True
    state["rngs"][slot] = rng_next
    state["row_max"][slot] = rmax
    state["temps"][slot] = float(temp)
    state["top_ps"][slot] = float(row_top_p)
    state["min_ps"][slot] = float(row_min_p)
    live = torch.full((1,), active0, device=dev)
    if per_row_sampling:
        # the prompt's occurrences and the first token when it is written
        count_tokens(pen["counts"], first[None], live)
        state["counts"][slot] = pen["counts"][0]
        for name in ("rep_ps", "freq_ps", "pres_ps"):
            state[name][slot] = pen[name][0]
    if no_repeat_ngram:
        state["ngram_on"][slot] = bool(row_ngram_on)
    if grammar is not None:
        state["gstate"][slot] = grammar_step(gs_row, first[None], grammar,
                                             active=live)[0]
        state["gram_on"][slot] = bool(row_gram_on)
    if "med_on" in state:
        state["h_last"][slot] = 0.0
        state["med_on"][slot] = bool(medusa_row)
        if "log_mps" in state:
            state["log_mps"][slot] = log_min_p(row_min_p, dev)[0]
    return state


def _medusa_prefill(params, prompt, plen: int, slot: int, cfg,
                    cache: dict, tp=None) -> torch.Tensor:
    """The solo Medusa decode's prefill (``models/gpt.py::prefill`` on a
    head-major cache of the bucket's width) of one row, its K/V copied
    into slot ``slot`` of the fused shared cache -> its [1, P, V] logits."""
    P = prompt.shape[1]
    row = init_kv_cache(cfg, 1, P, device=prompt.device, tp=tp)
    logits0, _ = prefill(params, prompt, cfg, row, prompt_len=plen, tp=tp)
    for li, kv in enumerate(cache["kv"]):
        kv[slot, :P] = torch.cat([row["k"][li][0].transpose(0, 1),
                                  row["v"][li][0].transpose(0, 1)],
                                 dim=1).reshape(P, -1)
    return logits0


def _medusa_filter(temp, top_k: int, top_p, per_row: bool,
                   row_top_p=None, row_min_p=None, row_log_mp=None):
    """[R, V] logits -> sampling distributions, a Medusa row's filter
    (JAX's ``_medusa_dist``): temperature (``temp`` [1]), top-k and the
    engine's top-p, or with ``per_row`` the row's top-p and min-p, each
    applied only where it is on (1.0 and 0.0 are off, bit for bit), then
    the softmax of ``speculative._dist``."""
    if not per_row:
        return lambda logits: _dist(logits, temp, top_k, False, top_p)

    def filt(logits):
        x = apply_top_k(logits / temp, top_k, -1e10)
        x = torch.where(row_top_p < 1.0, apply_top_p(x, row_top_p, -1e10), x)
        x = torch.where(row_min_p > 0.0,
                        apply_min_p(x, 0.0, -1e10, row_log_mp), x)
        return _softmax(x)

    return filt


@torch.no_grad()
def ragged_chunk(params, state, cfg, chunk=64, top_k=50, greedy=False,
                 mask_value=-1e10, eos_id=-1, pad_id=0, top_p=1.0,
                 per_row_sampling=False, no_repeat_ngram=0, grammar=None,
                 eager=False, tp=None) -> dict:
    """Advance every live row ``chunk`` steps, in place (done and free rows
    are inert): one replay of the chunk's graph on the card (the first
    chunk of a state captures it; eagerly on the CPU, and with ``eager``),
    JAX's ``lax.scan`` of the chunk. Every slot's key is split once per
    step, live or not, so a row's key at step n of its life depends on its
    seed and n alone; the chunk's keys go to the card in one copy and its
    noise is drawn inside the graph. Nothing is read back from the
    device. ``no_repeat_ngram`` and ``grammar`` (the engine's tables) are
    the engine's; each row's bits in the state say whether they apply to
    it. ``tp``: the model group (a group of more than one rank issues the
    chunk's steps from the host)."""
    top_p = float(top_p)
    grammar = grammar_tables(grammar, state["buf"].device)
    key = (id(params), cfg, int(chunk), int(top_k), bool(greedy),
           float(mask_value), int(eos_id), int(pad_id), top_p,
           bool(per_row_sampling), int(no_repeat_ngram or 0),
           None if grammar is None else id(grammar), bool(eager), id(tp))
    runner = state.get("graph")
    if runner is None or runner.key != key:
        dev = state["buf"].device
        runner = RaggedGraph(
            params, cfg, state, int(chunk), top_k=top_k, greedy=greedy,
            mask_value=mask_value, eos_id=eos_id, pad_id=pad_id,
            top_p=torch.full((1,), top_p, device=dev) if top_p < 1.0
            else 1.0, per_row=per_row_sampling,
            ngram=int(no_repeat_ngram or 0), gram=grammar, eager=eager,
            tp=tp)
        runner.key = key
        state["graph"] = runner
    state["rngs"], subs = prng.split_rows_chain(state["rngs"], chunk)
    runner.run(None if greedy else subs)
    return state


class MedusaGraph:
    """``chunk`` verify iterations of every row of the engine's state
    (JAX's ``medusa_chunk``) as one block graph (``decode/graphs.py``).
    The chunk's noise is drawn inside it from :attr:`keys` [chunk, B, 3,
    2], each row's step keys: the first split (a Medusa row's proposal
    key, a plain row's sampling key), then a Medusa row's acceptance and
    residual keys. ``scratch`` is the head-major cache one row's verify
    runs on (the ragged cache's slots and gamma + 1 more: the solo
    cache's size). ``tp``: the model group (its K/V heads in the scratch;
    a group of more than one rank issues the chunk's iterations from the
    host)."""

    def __init__(self, params: dict, cfg, st: dict, hw: torch.Tensor,
                 hb: torch.Tensor, chunk: int, *, top_k: int, greedy: bool,
                 mask_value: float, eos_id: int, pad_id: int, top_p=1.0,
                 per_row: bool = False, ngram: int = 0,
                 gram: dict | None = None, eager: bool = False, tp=None):
        dev = st["buf"].device
        self.params, self.cfg, self.st, self.chunk = params, cfg, st, chunk
        self.tp = tp
        self.hw, self.hb = hw, hb
        self.gamma = hw.shape[0]
        self.top_k, self.greedy, self.mask_value = top_k, greedy, mask_value
        self.eos_id, self.pad_id, self.top_p = eos_id, pad_id, top_p
        self.per_row, self.ngram, self.gram = per_row, ngram, gram
        B, M = st["buf"].shape
        self.scratch = verify_scratch(cfg, M, self.gamma + 1, dev, tp)
        self.keys = None if greedy else torch.zeros(
            (chunk, B, 3, 2), dtype=torch.int64, device=dev)
        self._idx = torch.arange(self.gamma + 1, device=dev)[None]
        self._cols = torch.arange(M, device=dev)[None]
        self.graph = graphs.BlockGraph(self._block, dev,
                                       eager or graphs.on_group(tp))

    def run(self, keys: np.ndarray | None) -> None:
        if self.keys is not None:
            graphs.load_keys(self.keys, keys)
        self.graph.run()

    def _block(self) -> None:
        self._noise = None
        if self.keys is not None:
            k, B = self.keys.shape[:2]
            g, V = self.gamma, self.cfg.vocab_size
            first = self.keys[:, :, 0].reshape(k * B, 2)
            self._noise = (
                prng.gumbel(first, (g, V)).reshape(k, B, g, V),
                prng.uniform_from_bits(prng.bits_keys(
                    self.keys[:, :, 1].reshape(k * B, 2), (g,))).reshape(
                        k, B, g),
                prng.gumbel(self.keys[:, :, 2].reshape(k * B, 2),
                            (V,)).reshape(k, B, V),
                draw_noise(self.keys[:, :, 0], V))
        for i in range(self.chunk):
            self._iteration(i)

    def _row_filter(self, b: int):
        st = self.st
        sl = slice(b, b + 1)
        if self.per_row:
            return _medusa_filter(st["temps"][sl], self.top_k, 1.0, True,
                                  st["top_ps"][sl], st["min_ps"][sl],
                                  st["log_mps"][sl])
        return _medusa_filter(st["temps"][sl], self.top_k, self.top_p, False)

    def _iteration(self, i: int) -> None:
        st, g, cache = self.st, self.gamma, self.st["cache"]
        buf, pos, done, last = st["buf"], st["pos"], st["done"], st["last"]
        row_max, med, h_last = st["row_max"], st["med_on"], st["h_last"]
        lengths = cache["lengths"]
        B = buf.shape[0]
        active = ~(done | (pos >= row_max))
        rows = []
        for b in range(B):
            noise = (None, None, None) if self._noise is None else \
                tuple(n[i, b] for n in self._noise[:3])
            load_row(cache, b, self.scratch)
            rows.append(medusa_verify(
                self.params, self.cfg, self.hw, self.hb, h_last[b],
                last[b:b + 1], self.scratch, self._row_filter(b),
                self.greedy, *noise, tp=self.tp))
            store_row(cache, b, self.scratch, g + 1)
        d = torch.stack([r[0] for r in rows])                  # [B, g]
        n = torch.stack([r[1] for r in rows])                  # [B]
        t_new = torch.stack([r[2] for r in rows])              # [B]
        h_rows = torch.stack([r[3] for r in rows])             # [B, g+1, D]
        # plain rows: the plain chunk's step on the block's first query
        logits = torch.stack([r[4][0] for r in rows])          # [B, V]
        logits = apply_no_repeat_ngram(logits, buf, pos, self.ngram,
                                       self.mask_value,
                                       row_on=st.get("ngram_on"))
        if self.gram is not None:
            logits = grammar_mask(logits, st["gstate"], self.gram,
                                  budget_left=row_max - pos,
                                  row_on=st.get("gram_on"))
        counts = st.get("counts")
        nxt = sample_rows(
            logits, st["temps"], self.top_k, self.mask_value, self.greedy,
            self.top_p, 0.0, st["top_ps"] if self.per_row else None,
            st["min_ps"] if self.per_row else None,
            None if self._noise is None else self._noise[3][i],
            counts=counts,
            **{k: st[k] for k in ("rep_ps", "freq_ps", "pres_ps")
               if k in st})
        # the rows' windows: a Medusa row's d_1..d_n, t_new, cut after an
        # EOS; a plain row's one token
        idx = self._idx
        win = torch.where(idx < n[:, None], torch.cat([d, d[:, -1:]], 1),
                          torch.where(idx == n[:, None], t_new[:, None],
                                      self.pad_id))
        e = torch.where((win == self.eos_id) & (idx <= n[:, None]), idx,
                        g + 2).min(1).values
        window = torch.where(med[:, None], win,
                             torch.where(idx == 0, nxt[:, None], self.pad_id))
        limit = torch.where(active, torch.where(med, torch.minimum(
            n + 1, e + 1), 1), 0)
        done_step = torch.where(med, e <= n, nxt == self.eos_id)
        # budget-clamped writes (the solo decode clamps its buffer instead)
        wlimit = torch.minimum(limit, (row_max - pos).long()).clamp(0, g + 1)
        offs = self._cols - pos[:, None]                        # [B, M]
        hit = (offs >= 0) & (offs < wlimit[:, None])
        take = window.gather(1, offs.clamp(0, g)).to(buf.dtype)
        torch.where(hit, take, buf, out=buf)
        at = (limit - 1).clamp(min=0)[:, None]
        last_new = window.gather(1, at)[:, 0]
        h_new = h_rows.gather(1, at[:, :, None].expand(
            B, 1, h_rows.shape[2]))[:, 0]
        new_pos = pos + wlimit.to(pos.dtype)
        torch.logical_or(done, (active & done_step) | (new_pos >= row_max),
                         out=done)
        torch.where(active, last_new, last, out=last)
        h_last.copy_(torch.where((active & med)[:, None], h_new, h_last))
        lengths.copy_(torch.where(active, new_pos - 1, lengths))
        pos.copy_(new_pos)
        plain = active & ~med
        if counts is not None:
            count_tokens(counts, nxt, plain)
        if self.gram is not None:
            st["gstate"].copy_(grammar_step(st["gstate"], nxt, self.gram,
                                            active=plain))


@torch.no_grad()
def medusa_chunk(params, hw, hb, state, cfg, med_rows: np.ndarray,
                 chunk=16, top_k=50, greedy=False, mask_value=-1e10,
                 eos_id=-1, pad_id=0, top_p=1.0, per_row_sampling=False,
                 no_repeat_ngram=0, grammar=None, eager=False,
                 tp=None) -> dict:
    """Advance every live row ``chunk`` verify iterations, in place: one
    replay of the Medusa chunk's graph (:class:`MedusaGraph`; eagerly on
    the CPU and with ``eager``). Rows with ``med_on`` run their solo
    Medusa iteration; the others the plain chunk's step on the block's
    first query. The keys, on the host: every slot's running key splits
    once a step (the proposal's or the plain sample's key), then a Medusa
    row's (``med_rows`` [slots] bool, the host's copy of ``med_on``)
    splits in three (next key, acceptance, residual) when sampling, as
    JAX's chunk does. ``tp``: the model group, as :func:`ragged_chunk`
    takes it."""
    top_p = float(top_p)
    grammar = grammar_tables(grammar, state["buf"].device)
    key = (id(params), id(hw), cfg, int(chunk), int(top_k), bool(greedy),
           float(mask_value), int(eos_id), int(pad_id), top_p,
           bool(per_row_sampling), int(no_repeat_ngram or 0),
           None if grammar is None else id(grammar), bool(eager), id(tp))
    runner = state.get("medusa_graph")
    if runner is None or runner.key != key:
        dev = state["buf"].device
        runner = MedusaGraph(
            params, cfg, state, hw, hb, int(chunk), top_k=top_k,
            greedy=greedy, mask_value=mask_value, eos_id=eos_id,
            pad_id=pad_id, top_p=torch.full((1,), top_p, device=dev)
            if top_p < 1.0 else 1.0, per_row=per_row_sampling,
            ngram=int(no_repeat_ngram or 0), gram=grammar, eager=eager,
            tp=tp)
        runner.key = key
        state["medusa_graph"] = runner
    rngs = state["rngs"]
    keys = None if greedy else np.zeros((chunk, len(rngs), 3, 2), np.uint32)
    for i in range(chunk):
        rngs, sub = prng.split_rows(rngs)
        if keys is not None:
            keys[i, :, 0] = sub
            three = prng.split_rows_n(rngs, 3)
            keys[i, :, 1:] = three[:, 1:]
            rngs = np.where(med_rows[:, None], three[:, 0], rngs)
    state["rngs"] = rngs
    runner.run(keys)
    return state


def _pack_snapshot(state) -> torch.Tensor:
    """Everything the harvest reads in ONE tensor, [slots, max_len + 2]:
    the token buffer, then pos, then done. One fetch per chunk."""
    return torch.cat([state["buf"], state["pos"][:, None],
                      state["done"][:, None].to(torch.int32)], dim=1)


def _start_fetch(snapshot: torch.Tensor):
    """Begin copying a snapshot to the host without blocking: pinned memory
    and an event on the issuing stream. Returns what :func:`_finish_fetch`
    waits on."""
    if snapshot.device.type != "cuda":
        return snapshot, None
    host = torch.empty(snapshot.shape, dtype=snapshot.dtype, pin_memory=True)
    host.copy_(snapshot, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _finish_fetch(fetch) -> np.ndarray:
    host, event = fetch
    if event is not None:
        event.synchronize()
    return host.numpy()


@dataclass(frozen=True)
class _Admission:
    """What ``admit_row`` takes of one request, in a slot: the same on
    every rank of a model group. The window batcher's plan sends its
    group's rows as such records too (``serve/batcher.py``)."""
    slot: int
    prompt_ids: tuple
    key: tuple                   # the row's PRNG key, two uint32
    rmax: int
    temp: float
    top_p: float = 1.0
    min_p: float = 0.0
    penalties: tuple = _NEUTRAL_PEN
    ngram_on: bool = False
    gram_on: bool = False
    medusa: bool = False         # a Medusa row


class _PlanChannel:
    """One step's plan, broadcast from rank 0 of a model group as one
    int64 tensor of a fixed size: [op, records, the step's ``words``],
    then ``slots`` records (:class:`_Admission`) of [slot, plen, key (2),
    rmax, temp, top_p, min_p, penalties (3) as float64 bits, n-gram on,
    grammar on, Medusa row, the prompt's ids padded to max_len]. op 1: run
    the step; op 0: "stop". The engine's step admits the records' rows and
    runs a chunk, its one word saying whether that is the Medusa chunk;
    the window batcher's decodes one group, a record a row, its words the
    group's batch-wide options. On the group's device (the card under
    NCCL)."""

    HEAD, FIELDS = 2, 14

    def __init__(self, tp, slots: int, max_len: int, words: int = 1):
        import torch.distributed as dist

        self.dist, self.group = dist, tp.group
        self.src = dist.get_global_rank(tp.group, 0)
        self.words = words
        self.width = self.FIELDS + max_len
        self.size = self.HEAD + words + slots * self.width
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if dist.get_backend(tp.group) == "nccl" else torch.device("cpu")

    def _record(self, plan: np.ndarray, i: int) -> np.ndarray:
        at = self.HEAD + self.words + i * self.width
        return plan[at:at + self.width]

    def send(self, records: list, words: tuple) -> None:
        plan = np.zeros(self.size, np.int64)
        plan[:self.HEAD] = (1, len(records))
        plan[self.HEAD:self.HEAD + self.words] = words
        for i, a in enumerate(records):
            rec = self._record(plan, i)
            rec[:5] = (a.slot, len(a.prompt_ids), *a.key, a.rmax)
            rec[5:11] = np.asarray((a.temp, a.top_p, a.min_p,
                                    *a.penalties), np.float64).view(np.int64)
            rec[11:14] = (a.ngram_on, a.gram_on, a.medusa)
            rec[14:14 + len(a.prompt_ids)] = a.prompt_ids
        self._broadcast(torch.from_numpy(plan).to(self.device))

    def stop(self, wait_s: float = 10.0) -> None:
        """Broadcast "stop", waiting at most ``wait_s`` for the group."""
        plan = torch.zeros(self.size, dtype=torch.int64, device=self.device)
        work = self.dist.broadcast(plan, self.src, group=self.group,
                                   async_op=True)
        work.wait(datetime.timedelta(seconds=wait_s))

    def recv(self):
        """-> (the next step's records, its words), or None at "stop"."""
        plan = torch.empty(self.size, dtype=torch.int64, device=self.device)
        self._broadcast(plan)
        plan = plan.cpu().numpy()
        if plan[0] == 0:
            return None
        out = []
        for i in range(int(plan[1])):
            rec = self._record(plan, i)
            f = rec[5:11].view(np.float64)
            out.append(_Admission(
                int(rec[0]), tuple(int(v) for v in rec[14:14 + rec[1]]),
                (int(rec[2]), int(rec[3])), int(rec[4]), float(f[0]),
                float(f[1]), float(f[2]), tuple(float(v) for v in f[3:6]),
                bool(rec[11]), bool(rec[12]), bool(rec[13])))
        return out, tuple(int(v) for v in
                          plan[self.HEAD:self.HEAD + self.words])

    def _broadcast(self, plan: torch.Tensor) -> None:
        self.dist.broadcast(plan, self.src, group=self.group)


@dataclass
class _Pending:
    prompt_ids: list
    temperature: float
    seed: int
    max_len: int
    submitted: float
    top_p: float = 1.0
    min_p: float = 0.0
    penalties: tuple = _NEUTRAL_PEN   # (repetition, frequency, presence)
    ngram: int = 0               # no_repeat_ngram size (0 = off)
    grammar: bool = False        # FSM-constrained decoding for this row
    medusa: bool = False         # per-row Medusa decoding
    admit_seq: int = -1          # chunks dispatched when the row joined
    rid: int = 0                 # the engine's request number (spans)
    submitted_ns: int = 0        # submit on the spans' clock
    submit_tid: int = 0          # the submitting thread's OS id
    started: float | None = None
    finished: float | None = None
    event: threading.Event = field(default_factory=threading.Event)
    result: list | None = None
    error: Exception | None = None
    # set by the client thread (submit timed out, or its stream closed);
    # the worker frees the slot at the next chunk boundary
    cancelled: bool = False
    # streamed rows (submit_stream): ("tokens", ids) / ("done", result) /
    # ("error", exc) items; emitted = buffer positions already delivered
    stream_q: queue.Queue | None = None
    emitted: int = 0


class ContinuousBatcher:
    """Persistent decode engine with slot admission.

    top_k/top_p/greedy are engine-wide; temperature and seed are
    per-request, and with ``per_row_sampling`` so are top_p, min_p and the
    penalties (rows at 1.0 / 0.0 are exact no-ops, so unfiltered requests
    still match their solo runs). ``no_repeat_ngram`` sets the engine's
    n-gram ban size and ``grammar`` (a ``decode.grammar.Grammar``) its
    FSM; a request turns either on for its row. ``medusa_heads``
    (``tools.medusa.load_medusa_heads``) lets a request decode as a Medusa
    row (``medusa=True``; its budget is cut to n_pos - gamma). Requests
    longer than the engine's max_len budget return the prompt unchanged.

    On a model group (``generator.tp`` of more than one rank) every rank
    builds the engine with the same arguments, ``medusa_heads`` included
    (whole on every rank); rank 0 takes the requests and the others call
    :meth:`serve_follower` (the module's docstring). There every chunk,
    the Medusa chunk too, is issued from the host; a group of one keeps
    its graphs."""

    def __init__(self, generator: Generator, slots: int = 8,
                 chunk: int = 64, max_len: int | None = None,
                 top_k: int = 50, greedy: bool = False,
                 mask_value: float = -1e10, max_queue: int = 256,
                 top_p: float = 1.0, per_row_sampling: bool = False,
                 no_repeat_ngram: int = 0, grammar=None,
                 medusa_heads: dict | None = None, eager: bool = False):
        assert generator.cfg.causal and not generator.cfg.pos_broadcast_bug,\
            "continuous batching requires the corrected causal config"
        self.gen = generator
        self.tp = generator.tp
        # a model group of more than one rank: rank 0 leads, the others
        # follow its plans
        self._group = self.tp is not None and self.tp.size > 1
        self.leader = not self._group or self.tp.rank == 0
        # where the parameters really are (with its index), for the worker
        self.device = generator.params["tok_emb"].device
        self.slots = slots
        self.chunk = chunk
        self.top_k, self.greedy, self.mask_value = top_k, greedy, mask_value
        self.top_p = float(top_p)
        self.per_row_sampling = bool(per_row_sampling)
        # the ban size n is the engine's; rows carry an on/off bit, so
        # n-gram and plain requests share the decode
        self.no_repeat_ngram = int(no_repeat_ngram or 0)
        # the grammar's tables are the engine's (one scheme a served
        # model); rows carry an on/off bit
        self.use_grammar = grammar is not None
        self._gram = grammar_tables(grammar, self.device)
        self.max_len = min(max_len or generator.cfg.seq_len,
                           generator.max_supported_len())
        # Medusa rows: the heads stacked once; the worker runs the Medusa
        # chunk only while a live Medusa row exists, so plain traffic never
        # pays the block verify. The verify overshoots by gamma positions,
        # so the budget shrinks by gamma (the solo decode's assert), and a
        # chunk of verify steps emits up to gamma + 1 tokens a row, so it
        # has fewer steps than a plain chunk
        self.medusa = medusa_heads is not None
        self._med_slots: set[int] = set()
        self._med_rows = np.zeros(slots, bool)   # the host's med_on
        if self.medusa:
            from ..decode.medusa import _stack_heads

            self._hw, self._hb = _stack_heads(medusa_heads,
                                              device=self.device)
            self.gamma = int(self._hw.shape[0])
            self.max_len = min(self.max_len,
                               generator.cfg.n_pos - self.gamma)
            self.chunk_med = max(4, chunk // (1 + self.gamma // 2))
        # admission control: requests queued beyond the live slots; 0 =
        # unbounded
        self.max_queue = max_queue
        # the chunks replay CUDA graphs on the card; eager=True issues
        # them from the host instead, to compare the two (no served path
        # passes it)
        self.eager = bool(eager)
        self.state = self._init_state()
        self._detached_state = None
        # the worker's stream and the detached decode's: a host wait of
        # one waits for nothing of the other
        self._stream = graphs.side_stream(self.device)
        self._detached_stream = graphs.side_stream(self.device)
        self._q: queue.Queue = queue.Queue()
        self._cancels: queue.Queue = queue.Queue()
        self._live: dict[int, _Pending] = {}
        self._free = list(range(slots))
        self._busy = False   # worker between dequeue and _live insertion
        # bounded: a long-running server must not grow per-request state
        # row_steps: slots x steps of every chunk; live_row_steps: the
        # rows live at its dispatch (finished rows not yet harvested
        # among them) x steps; row_tokens: the tokens the harvests found
        self.stats = {"chunks": 0, "admitted": 0, "served": 0,
                      "cancelled": 0, "rejected": 0, "row_steps": 0,
                      "live_row_steps": 0, "row_tokens": 0,
                      "join_delay_ms": deque(maxlen=4096)}
        self._rids = itertools.count()
        # each slot's row's position at its last harvest (row_tokens)
        self._seen_pos = np.zeros(slots, np.int64)
        # rows admitted behind a chunk in flight: the card reaches their
        # prefill when the worker's wait on that chunk's snapshot ends
        self._joining: list[_Pending] = []
        self._stop = False
        self._plan = _PlanChannel(self.tp, slots, self.max_len) \
            if self._group else None
        self._plan_open = self._group
        self._thread = threading.Thread(target=self._worker, daemon=True)
        if self.leader:
            self._thread.start()

    def _init_state(self) -> dict:
        return init_state(self.gen.cfg, self.slots, self.max_len,
                          device=self.device,
                          per_row_sampling=self.per_row_sampling,
                          no_repeat_ngram=self.no_repeat_ngram,
                          grammar=self.use_grammar, medusa=self.medusa,
                          tp=self.tp)

    def _sampling(self) -> dict:
        return dict(top_k=self.top_k, greedy=self.greedy,
                    mask_value=self.mask_value, eos_id=self.gen.eos_id,
                    pad_id=self.gen.pad_id, top_p=self.top_p,
                    per_row_sampling=self.per_row_sampling,
                    no_repeat_ngram=self.no_repeat_ngram,
                    grammar=self._gram)

    # ------------------------------------------------------------- client

    def accepts(self, top_k: int | None = None,
                greedy: bool | None = None,
                top_p: float | None = None,
                min_p: float | None = None,
                penalties: tuple | None = None,
                no_repeat_ngram: int | None = None,
                grammar: bool = False, medusa: bool = False) -> bool:
        """Whether a request's sampling params match the engine (top_k and
        greedy are engine-wide; top_p/min_p/penalties are engine-wide
        unless the engine runs per-row sampling; a nonzero no_repeat_ngram
        must be the engine's ban size; a grammar request needs an engine
        with the grammar; a medusa request an engine with Medusa heads).
        Callers fall back to a solo decode on a mismatch."""
        return ((top_k is None or top_k == self.top_k)
                and (greedy is None or greedy == self.greedy)
                and (self.per_row_sampling or top_p is None
                     or float(top_p) == self.top_p)
                and (self.per_row_sampling or min_p is None
                     or float(min_p) == 0.0)
                and (self.per_row_sampling or penalties is None
                     or tuple(float(v) for v in penalties) == _NEUTRAL_PEN)
                and (not no_repeat_ngram
                     or int(no_repeat_ngram) == self.no_repeat_ngram)
                and (not grammar or self.use_grammar)
                and (not medusa or self.medusa))

    def idle(self) -> bool:
        """True when the engine has no live or queued work. A lone request
        that joins an empty engine pays one harvest wait per chunk alone,
        so the pipeline decodes it detached (:meth:`run_detached`) and
        routes requests here only when there is concurrency; the streams
        are the same either way. A model group's engine is never idle in
        this sense: its leader decodes every request in the engine."""
        return not self._group and not self._live and self._q.empty() \
            and not self._busy

    def _validate_params(self, top_k, greedy, top_p, min_p, penalties,
                         no_repeat_ngram=0, grammar=False,
                         medusa=False) -> tuple:
        """JAX's checks, with its messages -> the request's penalties."""
        if grammar and not self.use_grammar:
            raise ValueError(
                "engine was built without a grammar table; construct "
                "ContinuousBatcher(grammar=...) for constrained requests")
        if medusa:
            if not self.medusa:
                raise ValueError(
                    "engine was built without medusa heads; construct "
                    "ContinuousBatcher(medusa_heads=...) for medusa "
                    "requests")
            # the solo Medusa decode's exclusions (history-dependent
            # transforms break the acceptance)
            pen = (tuple(float(v) for v in penalties)
                   if penalties is not None else _NEUTRAL_PEN)
            if pen != _NEUTRAL_PEN or no_repeat_ngram or grammar:
                raise ValueError(
                    "medusa rows reject penalties / no_repeat_ngram / "
                    "grammar (serve/pipeline.py contract)")
        if top_k is not None and top_k != self.top_k:
            raise ValueError(
                f"engine built for top_k={self.top_k}, got {top_k}")
        if greedy is not None and greedy != self.greedy:
            raise ValueError(
                f"engine built for greedy={self.greedy}, got {greedy}")
        if top_p is not None and not self.per_row_sampling \
                and float(top_p) != self.top_p:
            raise ValueError(
                f"engine built for top_p={self.top_p}, got {top_p}")
        if min_p and not self.per_row_sampling:
            raise ValueError(
                "engine needs per_row_sampling mode for min_p requests")
        pen = (tuple(float(v) for v in penalties)
               if penalties is not None else _NEUTRAL_PEN)
        if pen != _NEUTRAL_PEN and not self.per_row_sampling:
            raise ValueError(
                "engine needs per_row_sampling mode for penalty requests")
        if no_repeat_ngram and int(no_repeat_ngram) != self.no_repeat_ngram:
            raise ValueError(
                f"engine built for no_repeat_ngram={self.no_repeat_ngram}, "
                f"got {no_repeat_ngram}")
        return pen

    def _request(self, prompt_ids, temperature, seed, max_len, top_k,
                 greedy, top_p, min_p, penalties, no_repeat_ngram, grammar,
                 medusa) -> _Pending | None:
        """A request checked against the engine, or None when its prompt
        leaves no step to generate."""
        if not self.leader:
            raise RuntimeError(
                f"rank {self.tp.rank} of the model group follows rank 0's "
                "plans (serve_follower); send requests to rank 0")
        pen = self._validate_params(top_k, greedy, top_p, min_p, penalties,
                                    no_repeat_ngram, grammar, medusa)
        ml = int(min(max_len or self.max_len, self.max_len))
        if len(prompt_ids) >= ml:
            return None
        return _Pending(list(prompt_ids), float(temperature),
                        int(seed) if seed is not None
                        else int(time.time_ns() % 2**31), ml,
                        submitted=time.monotonic(), rid=next(self._rids),
                        submitted_ns=clock_ns(),
                        submit_tid=threading.get_native_id(),
                        top_p=float(top_p) if top_p is not None else 1.0,
                        min_p=float(min_p) if min_p is not None else 0.0,
                        penalties=pen, ngram=int(no_repeat_ngram or 0),
                        grammar=bool(grammar), medusa=bool(medusa))

    def submit(self, prompt_ids: list[int], temperature: float = 1.0,
               seed: int | None = None, max_len: int | None = None,
               timeout: float = 600.0, top_k: int | None = None,
               greedy: bool | None = None,
               top_p: float | None = None,
               min_p: float | None = None,
               penalties: tuple | None = None,
               no_repeat_ngram: int = 0, grammar: bool = False,
               medusa: bool = False) -> list:
        req = self._request(prompt_ids, temperature, seed, max_len, top_k,
                            greedy, top_p, min_p, penalties,
                            no_repeat_ngram, grammar, medusa)
        if req is None:
            return list(prompt_ids)  # zero generation steps (reference)
        self._enqueue(req)
        if not wait_for_worker(req.event, self._thread, timeout):
            self._request_cancel(req)  # free the slot; nobody is waiting
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def submit_stream(self, prompt_ids: list[int], temperature: float = 1.0,
                      seed: int | None = None, max_len: int | None = None,
                      timeout: float = 600.0, top_k: int | None = None,
                      greedy: bool | None = None,
                      top_p: float | None = None,
                      min_p: float | None = None,
                      penalties: tuple | None = None,
                      no_repeat_ngram: int = 0, grammar: bool = False,
                      medusa: bool = False):
        """Generator of lists of newly generated token ids as the engine's
        chunks complete: the streaming twin of :meth:`submit`. The deltas,
        concatenated, equal ``submit()``'s result less the prompt, bit for
        bit (the same per-row key chain; a token surfaces one harvest, at
        most two chunks, after it is made). An over-length prompt streams
        no delta. ``timeout`` bounds the wait for each delta.

        Validation and enqueue happen at call time, as in :meth:`submit`:
        the row joins the decode whether or not the returned generator is
        ever pulled. Closing the generator cancels the row."""
        req = self._request(prompt_ids, temperature, seed, max_len, top_k,
                            greedy, top_p, min_p, penalties,
                            no_repeat_ngram, grammar, medusa)
        if req is None:
            return iter(())  # zero generation steps
        req.stream_q = queue.Queue()
        req.emitted = len(prompt_ids)
        self._enqueue(req)
        return self._consume_stream(req, timeout)

    def _consume_stream(self, req: _Pending, timeout: float):
        try:
            while True:
                deadline = time.monotonic() + timeout
                while True:
                    try:
                        kind, payload = req.stream_q.get(timeout=min(
                            1.0, max(deadline - time.monotonic(), 0.0)))
                        break
                    except queue.Empty:
                        if not self._thread.is_alive():
                            raise RuntimeError("the batching worker thread "
                                               "is not running") from None
                        if time.monotonic() >= deadline:
                            self._request_cancel(req)
                            raise TimeoutError("generation timed out") \
                                from None
                if kind == "tokens":
                    yield payload
                elif kind == "done":
                    return
                else:
                    raise payload
        except GeneratorExit:
            # the consumer closed the stream (an SSE client went away):
            # free the row so queued requests get the slot
            self._request_cancel(req)
            raise

    def overloaded(self) -> bool:
        """Cheap admission pre-check."""
        return bool(self.max_queue) and self._q.qsize() >= self.max_queue

    def _enqueue(self, req: _Pending):
        """Admission control: bound the number of not-yet-admitted
        requests. qsize() is approximate under concurrency, but the only
        consumer is the single worker thread, so it never undercounts
        waiting requests: the bound cannot be exceeded by more than the
        handful of racing producers."""
        if self.overloaded():
            self.stats["rejected"] += 1
            raise EngineOverloaded(
                f"engine admission queue full "
                f"({self.max_queue} requests waiting)")
        self._q.put(req)

    def _request_cancel(self, req: _Pending):
        """Mark ``req`` cancelled (client thread). The worker frees its
        slot at the next chunk boundary; if the request is still queued,
        admission skips it. No device work is needed: a zombie row decodes
        inertly in its slot until ``admit_row`` overwrites every per-slot
        field on re-admission."""
        req.cancelled = True
        self._cancels.put(req)

    def drain(self, timeout: float = 30.0) -> bool:
        """Graceful shutdown, phase 1: wait for queued and in-flight rows to
        finish (the HTTP layer has already stopped accepting). Returns True
        when the engine went idle within ``timeout``. Requires three
        consecutive idle polls: _busy covers the dequeue->admit window, and
        the confirmation polls close the gap between the worker's q.get()
        returning and _busy going up."""
        deadline = time.monotonic() + timeout
        idle = 0
        while time.monotonic() < deadline:
            if self._q.qsize() == 0 and not self._live and not self._busy:
                idle += 1
                if idle >= 3:
                    return True
            else:
                idle = 0
            time.sleep(0.05)
        return (self._q.qsize() == 0 and not self._live
                and not self._busy)

    def _prompt_row(self, prompt_ids) -> torch.Tensor:
        p = len(prompt_ids)
        width = min(_bucket(p), self.max_len)
        prompt = np.full((1, width), self.gen.pad_id, np.int64)
        prompt[0, :p] = prompt_ids
        return torch.from_numpy(prompt).to(self.device)

    @torch.no_grad()
    def run_detached(self, prompt_ids: list[int],
                     temperature: float = 1.0, seed: int | None = None,
                     max_len: int | None = None, top_p: float = 1.0,
                     min_p: float = 0.0) -> list:
        """One request through the engine's own functions on a private
        state of the engine's shape (all ``slots`` rows, so every matrix
        product and kernel launch has the shape it has in the engine, and
        the row's stream is the engine row's), with every chunk issued back
        to back and ONE final packed fetch instead of a harvest per chunk.

        Used by the pipeline's idle-engine route. NOT thread-safe (the
        caller holds the pipeline's single-permit solo gate); does not
        touch the worker's live state. The row carries no penalties, no
        n-gram ban and no grammar, as in JAX: the pipeline sends requests
        with those to the engine itself. On a model group the request goes
        through the engine (:meth:`submit`): a decode of its own would
        issue collectives that no follower pairs."""
        if self._group:
            return self.submit(prompt_ids, temperature=temperature,
                               seed=seed, max_len=max_len, top_p=top_p,
                               min_p=min_p)
        # same admission contract as submit(): per-row sampling values on
        # a non-per-row engine must REJECT, not silently no-op
        self._validate_params(None, None, top_p, min_p, None)
        ml = int(min(max_len or self.max_len, self.max_len))
        p = len(prompt_ids)
        if p >= ml:
            return list(prompt_ids)   # zero generation steps (reference)
        with graphs.on_stream(self._detached_stream):
            return self._run_detached(prompt_ids, temperature, seed, ml,
                                      top_p, min_p)

    def _run_detached(self, prompt_ids, temperature, seed, ml, top_p,
                      min_p) -> list:
        p = len(prompt_ids)
        if self._detached_state is None:
            # admission into slot 0 replaces the slot's entire state, so
            # the private state is reusable; rows 1+ stay free and inert
            self._detached_state = self._init_state()
        opts = self._sampling()
        state = admit_row(
            self.gen.params, self._detached_state,
            self._prompt_row(prompt_ids), p, 0,
            prng.PRNGKey(int(seed) if seed is not None
                         else int(time.time_ns() % 2**31)),
            ml, float(temperature), self.gen.cfg, row_top_p=float(top_p),
            row_min_p=float(min_p), **opts)
        # upper bound of chunks; a done row is inert in later chunks, so
        # over-dispatching is exact. For LONG budgets (>= 6 chunks) one
        # midpoint done-check bounds the dead full-batch device time for
        # early-EOS songs at roughly half the budget; short budgets skip
        # it.
        n_chunks = max(-(-(ml - p - 1) // self.chunk), 0)
        for ci in range(n_chunks):
            state = ragged_chunk(self.gen.params, state, self.gen.cfg,
                                 chunk=self.chunk, eager=self.eager, **opts)
            if n_chunks >= 6 and ci == n_chunks // 2 - 1:
                if bool(_finish_fetch(_start_fetch(
                        _pack_snapshot(state)))[0, -1]):
                    break
        snap = _finish_fetch(_start_fetch(_pack_snapshot(state)))
        pos = int(snap[0, -2])
        return snap[0, :min(pos, ml)].tolist()

    def close(self, timeout: float = 30.0):
        """Stop the worker (the leader's: its followers' loops return)."""
        self._stop = True
        self._q.put(None)
        if self._thread.is_alive():
            self._thread.join(timeout)

    def serve_follower(self) -> None:
        """A follower rank's loop (ranks 1.. of a model group): apply each
        plan rank 0 broadcasts, the same admissions and chunks in the same
        order, until "stop". Blocks; raises what an admission or a chunk
        raises, and the caller's process is then to exit, so that the
        leader's pending collective raises at once (the module's
        docstring)."""
        if self.leader:
            raise RuntimeError("serve_follower runs on ranks 1.. of a "
                               "model group; rank 0 serves requests")
        bind_thread_to(self.device)
        with torch.no_grad(), graphs.on_stream(self._stream):
            while True:
                plan = self._plan.recv()
                if plan is None:
                    return
                admissions, (medusa,) = plan
                for a in admissions:
                    self._admit_row(a)
                self._chunk(bool(medusa))

    # ------------------------------------------------------------- engine

    def _admit_row(self, a: _Admission) -> None:
        """``admit_row`` of one admission into the engine's state, and the
        host's copy of its Medusa bit."""
        self.state = admit_row(
            self.gen.params, self.state, self._prompt_row(a.prompt_ids),
            len(a.prompt_ids), a.slot, a.key, a.rmax,
            a.temp, self.gen.cfg, row_top_p=a.top_p, row_min_p=a.min_p,
            row_penalties=a.penalties, row_ngram_on=a.ngram_on,
            row_gram_on=a.gram_on, medusa_row=a.medusa, tp=self.tp,
            **self._sampling())
        self._med_rows[a.slot] = a.medusa

    def _chunk(self, medusa: bool = False) -> None:
        """One chunk: the Medusa chunk while a live Medusa row exists
        (every row pays the block verify in it), else the plain one."""
        if medusa:
            self.state = medusa_chunk(
                self.gen.params, self._hw, self._hb, self.state,
                self.gen.cfg, self._med_rows, chunk=self.chunk_med,
                eager=self.eager, tp=self.tp, **self._sampling())
        else:
            self.state = ragged_chunk(
                self.gen.params, self.state, self.gen.cfg, chunk=self.chunk,
                eager=self.eager, tp=self.tp, **self._sampling())

    @staticmethod
    def _admission(req: _Pending, slot: int) -> _Admission:
        return _Admission(slot, tuple(req.prompt_ids),
                          prng.PRNGKey(req.seed), req.max_len,
                          req.temperature, req.top_p, req.min_p,
                          req.penalties, bool(req.ngram), req.grammar,
                          req.medusa)

    def _admit(self, req: _Pending, a: _Admission):
        slot = a.slot
        with span("engine.admit", rid=req.rid,
                  prompt_len=len(a.prompt_ids)):
            self._admit_row(a)
        if a.medusa:
            self._med_slots.add(slot)
        else:
            self._med_slots.discard(slot)
        req.started = time.monotonic()
        req.admit_seq = self.stats["chunks"]
        self._live[slot] = req
        self._seen_pos[slot] = len(a.prompt_ids)
        self.stats["admitted"] += 1
        self.stats["join_delay_ms"].append(
            (req.started - req.submitted) * 1000)

    def _harvest(self, fetch, seq):
        """Wait for a packed snapshot and fulfil finished rows. A done
        row's buffer is immutable afterwards, so reading it from any later
        snapshot is safe: the host frees the slot only here. A slot whose
        occupant was admitted at or after this snapshot's dispatch
        (admit_seq >= seq) is skipped: the snapshot's done flag still
        describes the slot's previous life (free slots read done=True)."""
        with span("engine.harvest_wait"):
            arr = _finish_fetch(fetch)
        if self._joining:
            end = clock_ns()
            for req in self._joining:
                add_span("engine.join", req.submitted_ns, end, rid=req.rid,
                         tid=req.submit_tid)
            self._joining.clear()
        with span("engine.harvest") as sp:
            served = self.stats["served"]
            tokens = self._fulfil(arr, seq)
            self.stats["row_tokens"] += tokens
            sp.count(tokens=tokens, served=self.stats["served"] - served)

    def _fulfil(self, arr: np.ndarray, seq: int) -> int:
        """:meth:`_harvest`'s work on a fetched snapshot -> the tokens its
        rows made since their last harvest."""
        buf, pos, done = arr[:, :-2], arr[:, -2], arr[:, -1].astype(bool)
        eligible = [(s, r) for s, r in self._live.items() if r.admit_seq < seq]
        tokens = 0
        for slot, req in eligible:
            end = min(int(pos[slot]), req.max_len)
            tokens += end - int(self._seen_pos[slot])
            self._seen_pos[slot] = end
            # a streamed row's new tokens: the cells of a row below pos are
            # written once and never again, so reading them from this
            # snapshot is final while the row keeps decoding
            if req.stream_q is not None and end > req.emitted:
                req.stream_q.put(("tokens",
                                  buf[slot, req.emitted:end].tolist()))
                req.emitted = end
        for slot, req in eligible:
            if not done[slot]:
                continue
            del self._live[slot]
            self._med_slots.discard(slot)
            req.result = buf[slot, :min(int(pos[slot]),
                                        req.max_len)].tolist()
            req.finished = time.monotonic()
            if req.stream_q is not None:
                req.stream_q.put(("done", req.result))
            req.event.set()
            self._free.append(slot)
            self.stats["served"] += 1
        return tokens

    def _drain_cancels(self):
        """Free the slots of cancelled live rows (worker thread only).
        Popping from ``_live`` is sufficient: harvest acts only on live
        slots, and the next admission into the slot replaces the zombie
        row's entire state."""
        while True:
            try:
                req = self._cancels.get(block=False)
            except queue.Empty:
                return
            for slot, r in list(self._live.items()):
                if r is req:
                    del self._live[slot]
                    self._med_slots.discard(slot)
                    self._free.append(slot)
                    self.stats["cancelled"] += 1

    def _fail_all(self, exc: Exception, taken: list = ()):
        """Deliver ``exc`` to every live and queued request, and to those
        of ``taken`` (dequeued for admission) not yet told, reset the
        engine to empty, and keep serving: one poisoned request or a
        transient error must not wedge the server."""
        for req in [*self._live.values(),
                    *(r for r in taken if not r.event.is_set())]:
            req.error = exc
            if req.stream_q is not None:
                req.stream_q.put(("error", exc))
            req.event.set()
        self._live.clear()
        self._joining.clear()
        self._med_slots.clear()
        self._med_rows[:] = False
        self._free = list(range(self.slots))
        while True:
            try:
                req = self._q.get(block=False)
            except queue.Empty:
                break
            if req is None:
                self._q.put(None)  # preserve the shutdown signal
                break
            req.error = exc
            if req.stream_q is not None:
                req.stream_q.put(("error", exc))
            req.event.set()
        reset_state(self.state)

    def _worker(self):
        bind_thread_to(self.device)
        try:
            with graphs.on_stream(self._stream):
                self._work()
        finally:
            self._stop_followers()

    def _stop_followers(self) -> None:
        """Send the followers "stop", once (a leader's worker on its way
        out)."""
        if self._plan_open:
            self._plan_open = False
            self._plan.stop()

    def _work(self):
        pending_fetch = None
        while not self._stop:
            # a model group's followers are inside this iteration's
            # admissions and chunk from its plan until the chunk returns
            admits, in_step = [], False
            try:
                # one iteration: engine.loop holds the bookkeeping between
                # its other spans, so the worker's spans tile its time
                with span("engine.loop"):
                    self._drain_cancels()
                    # take as many queued requests as there are free slots
                    try:
                        while len(admits) < len(self._free):
                            if not self._live and not admits \
                                    and pending_fetch is None:
                                with span("engine.wait_requests"):
                                    req = self._q.get()
                            else:
                                req = self._q.get(block=False)
                            # _busy covers the dequeued-but-not-yet-in-_live
                            # window so drain() can't report idle while a
                            # request is mid-admission
                            self._busy = True
                            if req is None:
                                return
                            if req.cancelled:
                                self.stats["cancelled"] += 1
                                # not busy while blocked in the next get()
                                self._busy = bool(admits)
                                continue
                            add_span("engine.queue", req.submitted_ns,
                                     rid=req.rid, tid=req.submit_tid)
                            admits.append(req)
                    except queue.Empty:
                        pass
                    plan = [self._admission(r, self._free.pop())
                            for r in admits]
                    # the Medusa chunk only while a live Medusa row exists
                    medusa = any(s in self._live for s in self._med_slots) \
                        or any(a.medusa for a in plan)
                    if plan or self._live:
                        if self._plan is not None:
                            in_step = True
                            self._plan.send(plan, (medusa,))
                        for req, a in zip(admits, plan):
                            self._admit(req, a)
                            # the prefill queues behind the chunk in flight,
                            # if any (engine.join ends in _harvest)
                            if pending_fetch is None:
                                add_span("engine.join", req.submitted_ns,
                                         rid=req.rid, tid=req.submit_tid)
                            else:
                                self._joining.append(req)
                    self._busy = False
                    if not self._live and pending_fetch is None:
                        continue

                    if self._live:
                        steps = self.chunk_med if medusa else self.chunk
                        live = len(self._live)
                        with span("engine.chunk", rows=live, slots=self.slots,
                                  steps=steps):
                            self._chunk(medusa)
                        in_step = False
                        self.stats["chunks"] += 1
                        self.stats["row_steps"] += self.slots * steps
                        self.stats["live_row_steps"] += live * steps
                        # depth-1 lookahead: the PREVIOUS chunk's flags are
                        # read while this one computes
                        prev, pending_fetch = (
                            pending_fetch,
                            (_start_fetch(_pack_snapshot(self.state)),
                             self.stats["chunks"]))
                        if prev is not None:
                            self._harvest(*prev)
                    else:
                        # nothing live: drain the outstanding fetch
                        prev, pending_fetch = pending_fetch, None
                        self._harvest(*prev)
            except Exception as exc:  # noqa: BLE001 - worker must survive
                pending_fetch = None
                self._busy = False
                if self._group:
                    # followers that wait for a plan stop before the
                    # requests fail; those inside the step cannot take a
                    # "stop" (the module's docstring). The engine closes
                    try:
                        if in_step:
                            self._plan_open = False
                        self._stop_followers()
                    finally:
                        self._fail_all(exc, admits)
                        self._stop = True
                    return
                self._fail_all(exc, admits)
