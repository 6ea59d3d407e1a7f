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

The decode state (cache, token buffer, positions, flags, the rows'
sampling values) lives on the device and every step updates it in place,
so its tensors keep their addresses: ``admit_row``, the harvest and a CUDA
graph all see the same ones. :class:`RaggedGraph` replays a block of
steps from one graph on the card (eagerly on the CPU), the block's Gumbel
noise drawn inside it from a buffer of the rows' step keys; as JAX's
``while_loop`` does, ``generate_kv_ragged`` runs until every row is done,
and looks at the done flags once a block. Each row's stream is a function
of the parameters, its prompt and its key alone: per-row keys are advanced
on the host (``utils/prng.py``). The history-dependent transforms go in
JAX's order in every step: the n-gram ban, the grammar's mask (budget
``row_max - pos``), then the penalties inside the sampler; the counts and
the grammar's states advance for active rows only. ``generate_kv_ragged``
takes them batch-wide with a state per row, the engine a row at a time
(``ngram_on``, ``gram_on`` and the per-row penalties in its state).
On tensor-parallel params (``tp=``, a ``parallel.collectives.
TensorParallel``; every rank of the model group runs the same calls with
its blocks, ``parallel/mesh.py::shard_params(tp=True)``) the cache holds
the rank's K/V heads, [B, M, 2 * Hkv_r * Dh] a layer; K1 and the fold
kernel run on its heads and K2 on its FF columns, the out-projection and
the FFN are summed over the group and the logits gathered whole before
the sampler, so every rank writes the same tokens, the unsharded ones. A
group of more than one rank issues its steps from the host (no
collective inside a captured graph); a group of one keeps its graphs
(``TensorParallel`` takes no collective at size 1).
``decode_block_ragged`` is the ragged verify step of the engine's Medusa
rows: [B, W] blocks at per-row lengths, each row computed as the solo
verify step computes it (``models/gpt.py::decode_block`` over a head-major
copy of the row's cache with W more slots; under ``tp`` a copy of the
rank's K/V heads), so an engine Medusa row gives its solo Medusa run's
bits.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..models.gpt import (GPTConfig, _embed, _head, _qkv_dims, decode_block,
                          decode_layers_fused, init_kv_cache, prefill_fused)
from ..ops.decode_fold import fold_decode
from ..utils import prng
from . import graphs
from .grammar import (grammar_mask, grammar_step, grammar_tables,
                      scan_prompt_state)
from .sampling import (apply_no_repeat_ngram, count_tokens, log_min_p,
                       penalties_on, penalty_tensor, sample_rows,
                       token_counts)


def init_ragged_cache(cfg: GPTConfig, batch: int, max_len: int,
                      device=None, tp=None) -> dict:
    """Per layer [B, max_len, 2 * KVD] (under ``tp`` this rank's K/V
    heads) and per-row ``lengths`` [B] int32."""
    shape = (batch, max_len, 2 * _qkv_dims(cfg, tp)[1] * cfg.head_dim)
    return {"kv": [torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
                   for _ in range(cfg.n_layer)],
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}


@torch.no_grad()
def prefill_ragged(params: dict, ids: torch.Tensor,
                   prompt_lens: torch.Tensor, cfg: GPTConfig, cache: dict,
                   tp=None):
    """[B, T] padded prompts with per-row lengths -> ([B, T, V] logits,
    cache). K/V of all T slots, pads included, go to the cache; keys at or
    past a row's length are masked. The cache is written in place, its
    ``lengths`` too where it has them."""
    assert cfg.causal and not cfg.pos_broadcast_bug
    valid = prompt_lens.to(device=ids.device, dtype=torch.int32)
    logits = prefill_fused(params, ids, valid, cfg, cache["kv"], tp)
    if "lengths" in cache:
        cache["lengths"].copy_(valid)
    return logits, cache


def _step_logits(params: dict, last: torch.Tensor, cache: dict,
                 cfg: GPTConfig, tp=None) -> torch.Tensor:
    """The layers of one ragged step: [B] last tokens at per-row positions
    t = lengths -> [B, V] f32 logits; the rows' new K/V go to slot t[b]
    (positions past the end clamp to the last slot and the last position
    row, as XLA's dynamic slices do; such a row is finished). The lengths
    are not advanced."""
    B = last.shape[0]
    t = cache["lengths"]
    M = cache["kv"][0].shape[1]
    slot = t.clamp(max=M - 1).long()
    pos_rows = params["pos"][t.clamp(max=params["pos"].shape[0] - 1).long()]
    x = _embed(params, last[:, None], pos_rows[:, None], cfg.torch_dtype)
    rows = torch.arange(B, device=last.device)
    x = decode_layers_fused(params, x, cache["kv"], (rows, slot), t, cfg,
                            fold_decode, tp)
    return _head(params, x, tp)[:, 0]


@torch.no_grad()
def decode_step_ragged(params: dict, last: torch.Tensor, cache: dict,
                       cfg: GPTConfig, tp=None):
    """[B] last tokens at per-row positions t = lengths -> ([B, V] f32
    logits, cache with lengths + 1, advanced in place)."""
    logits = _step_logits(params, last, cache, cfg, tp)
    cache["lengths"].add_(1)
    return logits, cache


def verify_scratch(cfg: GPTConfig, max_len: int, width: int,
                   device=None, tp=None) -> dict:
    """The head-major cache one row of a ragged verify runs on: the
    ragged cache's ``max_len`` slots and ``width`` more (the solo verify's
    ``max_len + gamma + 1`` for a block of gamma + 1); under ``tp`` this
    rank's K/V heads, as its ragged cache holds."""
    return init_kv_cache(cfg, 1, max_len + width, device=device, tp=tp)


def load_row(cache: dict, b: int, scratch: dict) -> None:
    """Row ``b`` of the fused ragged cache into the head-major ``scratch``
    (its first M slots; the rest keep what they held, which no query of a
    verify at t + W <= M + W sees), and its length."""
    for li, kv in enumerate(cache["kv"]):
        M = kv.shape[1]
        k, v = scratch["k"][li], scratch["v"][li]
        Hkv, Dh = k.shape[1], k.shape[3]
        row = kv[b].view(M, 2, Hkv, Dh)
        k[0, :, :M].copy_(row[:, 0].transpose(0, 1))
        v[0, :, :M].copy_(row[:, 1].transpose(0, 1))
    scratch["length"].copy_(cache["lengths"][b:b + 1])


def store_row(cache: dict, b: int, scratch: dict, width: int) -> None:
    """The ``width`` K/V entries a verify wrote into ``scratch`` from row
    ``b``'s length t on, back into the fused cache at slots t.. that it
    has; the entries past its end are dropped (their writes go to slot t
    with t's own values)."""
    t = cache["lengths"][b:b + 1].long()
    offs = torch.arange(width, device=t.device)
    for li, kv in enumerate(cache["kv"]):
        M = kv.shape[1]
        k, v = scratch["k"][li][0], scratch["v"][li][0]   # [Hkv, Ms, Dh]
        Hkv, Ms, Dh = k.shape
        at = t.clamp(max=Ms - width) + offs               # decode_block's
        vals = torch.stack([k.index_select(1, at), v.index_select(1, at)],
                           dim=0)                         # [2, Hkv, W, Dh]
        vals = vals.permute(2, 0, 1, 3).reshape(width, 2 * Hkv * Dh)
        ok = (t + offs) < M
        kv[b].index_copy_(0, torch.where(ok, t + offs, t.clamp(max=M - 1)),
                          torch.where(ok[:, None], vals, vals[:1]))


@torch.no_grad()
def decode_block_ragged(params: dict, block: torch.Tensor, cache: dict,
                        cfg: GPTConfig, scratch: dict | None = None,
                        tp=None):
    """[B, W] token blocks from per-row positions t = lengths -> ([B, W, V]
    f32 logits, [B, W, D] hidden states, the cache with the W entries
    written where it has slots and ``lengths`` unchanged: the caller
    commits the accepted prefix by setting them, JAX's Medusa rewind).

    Each row is ``decode_block`` over ``scratch`` (made by
    :func:`verify_scratch` when None), a head-major copy of the row's
    cache with W more slots: the row's queries see its cached prefix and
    the block up to themselves, the block's own keys past the ragged
    cache's end included, and every product has the shape of the solo
    verify step's. ``tp``: the model group, ``params`` this rank's blocks
    and the caches its K/V heads; the logits and states are whole."""
    assert cfg.causal and not cfg.pos_broadcast_bug
    B, W = block.shape
    if scratch is None:
        scratch = verify_scratch(cfg, cache["kv"][0].shape[1], W,
                                 block.device, tp)
    logits, hidden = [], []
    for b in range(B):
        load_row(cache, b, scratch)
        lg, h, _ = decode_block(params, block[b:b + 1], scratch, cfg,
                                return_hidden=True, tp=tp)
        store_row(cache, b, scratch, W)
        logits.append(lg[0])
        hidden.append(h[0])
    return torch.stack(logits), torch.stack(hidden), cache


def draw_noise(sub_keys, vocab_size: int, device=None) -> torch.Tensor:
    """Gumbel noise for sampling keys [..., 2] (uint32 numpy, or an int64
    tensor on the device) -> [..., V]: row by row what
    ``jax.random.categorical(key, logits[None])`` adds to its logits."""
    lead = sub_keys.shape[:-1]
    return prng.gumbel(sub_keys.reshape(-1, 2), (vocab_size,),
                       device).reshape(*lead, vocab_size)


@torch.no_grad()
def ragged_steps(params: dict, st: dict, cfg: GPTConfig, noise, *,
                 steps: int, top_k: int, greedy: bool, mask_value: float,
                 eos_id: int, pad_id: int, top_p=1.0,
                 min_p: float = 0.0, per_row: bool = False,
                 log_mp: torch.Tensor | None = None, ngram: int = 0,
                 gram: dict | None = None, tp=None) -> dict:
    """Advance every live row of ``st`` by ``steps`` decode steps, in place
    (every tensor of ``st`` keeps its address); done rows and rows at
    their budget are inert. ``noise`` is [steps, B, V] (None when greedy).
    Nothing here reads a value back from the device or copies one to it.

    ``st``: buf [B, M] int32, pos/row_max [B] int32, last [B] int64,
    done [B] bool, temps/top_ps/min_ps [B] f32, cache. ``top_p`` and
    ``log_mp`` as :func:`sample_rows` takes them. With penalties ``st``
    holds ``counts`` [B, V] and either ``pen`` [3] (batch-wide) or
    ``rep_ps``/``freq_ps``/``pres_ps`` [B]; ``ngram`` bans n-grams, in the
    rows ``ngram_on`` [B] marks when ``st`` has it; ``gram`` (the
    grammar's tables) masks by ``gstate`` [B], in the rows ``gram_on``
    marks when ``st`` has it. ``tp``: the model group, ``params`` this
    rank's blocks (the module's docstring)."""
    buf, pos, done, last = st["buf"], st["pos"], st["done"], st["last"]
    lengths = st["cache"]["lengths"]
    counts = st.get("counts")
    per_row_pen = {k: st[k] for k in ("rep_ps", "freq_ps", "pres_ps")
                   if k in st}
    cols = torch.arange(buf.shape[1], device=buf.device)[None]
    for i in range(steps):
        logits = _step_logits(params, last, st["cache"], cfg, tp)
        logits = apply_no_repeat_ngram(logits, buf, pos, ngram, mask_value,
                                       row_on=st.get("ngram_on"))
        if gram is not None:
            logits = grammar_mask(logits, st["gstate"], gram,
                                  budget_left=st["row_max"] - pos,
                                  row_on=st.get("gram_on"))
        nxt = sample_rows(logits, st["temps"], top_k, mask_value, greedy,
                          top_p, min_p,
                          st["top_ps"] if per_row else None,
                          st["min_ps"] if per_row else None,
                          None if greedy else noise[i], log_mp,
                          counts=counts, penalties=st.get("pen"),
                          **per_row_pen)
        active = ~(done | (pos >= st["row_max"]))
        if counts is not None:
            count_tokens(counts, nxt, active)
        if gram is not None:
            st["gstate"].copy_(grammar_step(st["gstate"], nxt, gram,
                                            active=active))
        write = torch.where(active, nxt, pad_id).to(torch.int32)
        hit = (cols == pos[:, None]) & active[:, None]
        torch.where(hit, write[:, None], buf, out=buf)
        # inactive rows do not advance their cache length
        step = active.to(torch.int32)
        lengths.add_(step)
        pos.add_(step)
        torch.logical_or(done, (active & (nxt == eos_id))
                         | (pos >= st["row_max"]), out=done)
        torch.where(active, nxt, last, out=last)
    return st


class RaggedGraph:
    """``block`` steps of :func:`ragged_steps` over the state ``st`` (a
    dict of device tensors that keep their addresses) as one block graph
    (``decode/graphs.py``), the block's noise drawn inside it from
    :attr:`keys` [block, B, 2], the rows' step keys. ``top_p``: 1.0 (off)
    or a [1] tensor the owner fills; ``log_mp``: None or such a tensor
    (:func:`sampling.log_min_p`); with ``per_row`` the rows' own
    ``top_ps``/``min_ps``; ``ngram`` and ``gram`` as :func:`ragged_steps`
    takes them. The engine's chunks, its detached decode and
    ``generate_kv_ragged`` run on it. Under a ``tp`` group of more than
    one rank it issues its steps from the host."""

    def __init__(self, params: dict, cfg: GPTConfig, st: dict, block: int,
                 *, top_k: int, greedy: bool, mask_value: float,
                 eos_id: int, pad_id: int, top_p=1.0, log_mp=None,
                 per_row: bool = False, ngram: int = 0,
                 gram: dict | None = None, eager: bool = False,
                 capture_error_mode: str = "thread_local", tp=None):
        dev = st["buf"].device
        self.params, self.cfg, self.st, self.block = params, cfg, st, block
        self.opts = dict(top_k=top_k, greedy=greedy, mask_value=mask_value,
                         eos_id=eos_id, pad_id=pad_id, top_p=top_p,
                         per_row=per_row, log_mp=log_mp, ngram=ngram,
                         gram=gram, tp=tp)
        eager = eager or graphs.on_group(tp)
        B = st["buf"].shape[0]
        self.keys = None if greedy else torch.zeros(
            (block, B, 2), dtype=torch.int64, device=dev)
        self.graph = graphs.BlockGraph(self._block, dev, eager,
                                       capture_error_mode)

    def _block(self) -> None:
        noise = None if self.keys is None else draw_noise(
            self.keys, self.cfg.vocab_size)
        ragged_steps(self.params, self.st, self.cfg, noise, steps=self.block,
                     **self.opts)

    def run(self, subs: np.ndarray | None) -> None:
        """One block: ``subs`` [n, B, 2] uint32 are the step keys of its
        first n <= block steps (None when greedy), copied in before the
        replay; the steps past n must be inert."""
        if self.keys is not None:
            graphs.load_keys(self.keys, subs)
        self.graph.run()


def _row_keys(rngs, batch: int) -> np.ndarray:
    """[B, 2] uint32 keys from per-row keys, or from one key fanned out
    with ``fold_in(key, row)``."""
    arr = np.asarray(rngs, dtype=np.uint32)
    if arr.ndim == 1:
        key = (int(arr[0]), int(arr[1]))
        arr = np.asarray([prng.fold_in(key, i) for i in range(batch)],
                         np.uint32)
    return arr


class _RaggedLoop:
    """``generate_kv_ragged``'s state on the device for one graph key."""

    def __init__(self, params, cfg, batch: int, max_len: int, device,
                 top_k: int, greedy: bool, mask_value: float, eos_id: int,
                 pad_id: int, top_p_on: bool, min_p_on: bool, pen_on: bool,
                 ngram: int, gram: dict | None, block: int, eager: bool,
                 tp=None):
        dev = torch.device(device)
        self.block = block
        self.lock = threading.Lock()
        self.stream = graphs.side_stream(dev)

        def full(value, dtype):
            return torch.full((batch,), value, dtype=dtype, device=dev)

        self.st = {"cache": init_ragged_cache(cfg, batch, max_len, dev, tp),
                   "buf": torch.zeros((batch, max_len), dtype=torch.int32,
                                      device=dev),
                   "pos": full(0, torch.int32), "last": full(0, torch.int64),
                   "done": full(True, torch.bool),
                   "row_max": full(max_len, torch.int32),
                   "temps": full(1.0, torch.float32)}
        if pen_on:
            self.st["counts"] = torch.zeros((batch, cfg.vocab_size),
                                            device=dev)
            self.st["pen"] = torch.zeros((3,), device=dev)
        if gram is not None:
            self.st["gstate"] = full(0, torch.int64)
        self.top_p = torch.ones((1,), device=dev) if top_p_on else 1.0
        self.log_mp = torch.zeros((1,), device=dev) if min_p_on else None
        self.graph = RaggedGraph(params, cfg, self.st, block, top_k=top_k,
                                 greedy=greedy, mask_value=mask_value,
                                 eos_id=eos_id, pad_id=pad_id,
                                 top_p=self.top_p, log_mp=self.log_mp,
                                 ngram=ngram, gram=gram, eager=eager, tp=tp)


@torch.no_grad()
def generate_kv_ragged(params: dict, prompt: torch.Tensor, prompt_lens,
                       rngs, cfg: GPTConfig, max_len: int,
                       temperature: float = 1.0, top_k: int = 50,
                       eos_id: int = -1, pad_id: int = 0,
                       greedy: bool = False, mask_value: float = -1e10,
                       top_p: float = 1.0, min_p: float = 0.0,
                       penalties: tuple | None = None,
                       no_repeat_ngram: int = 0, grammar=None,
                       eager: bool = False, tp=None):
    """Heterogeneous batch: prompt [B, P] padded (on the params' device),
    prompt_lens [B] (host ints), one key per row (rngs [B, 2] uint32, what
    ``prng.key_rows(seeds)`` gives) or a single key, fanned out per row.
    Returns (tokens [B, max_len] int32, lengths [B] int32) on the device;
    row b holds its prompt then its generation, pad_id elsewhere.
    ``penalties`` (repetition, frequency, presence), ``no_repeat_ngram``
    and ``grammar`` (a ``decode.grammar.Grammar`` or its ``arrays``) are
    batch-wide, with the counts, the history and the FSM state per row.
    On the card the steps replay a CUDA graph of ``graphs.BLOCK`` steps
    keyed by B (and the sampling options); ``eager=True`` issues them from
    the host instead, to compare the two (no served path passes it).
    ``tp``: a ``parallel.collectives.TensorParallel`` and ``params`` this
    rank's blocks; every rank of the group makes the same call (the
    module's docstring)."""
    B, P = prompt.shape
    assert max_len <= cfg.n_pos, (
        f"max_len={max_len} exceeds the positional table "
        f"(n_pos={cfg.n_pos}); cap decode length at cfg.n_pos")
    dev = prompt.device
    top_p = 1.0 if top_p is None else float(top_p)
    min_p = 0.0 if min_p is None else float(min_p)
    pen_on = penalties is not None and penalties_on(*penalties)
    ngram = int(no_repeat_ngram or 0)
    gram = grammar_tables(grammar, dev)
    key = ("ragged", id(params), cfg, B, max_len, str(dev), int(top_k),
           bool(greedy), float(mask_value), int(eos_id), int(pad_id),
           top_p < 1.0, min_p > 0.0, pen_on, ngram,
           None if gram is None else id(gram), graphs.BLOCK, bool(eager),
           id(tp))
    loop = graphs.state_for(key, lambda: _RaggedLoop(
        params, cfg, B, max_len, dev, int(top_k), bool(greedy),
        float(mask_value), int(eos_id), int(pad_id), top_p < 1.0,
        min_p > 0.0, pen_on, ngram, gram, graphs.BLOCK, eager, tp))
    plens_host = [int(v) for v in np.asarray(
        prompt_lens.cpu() if isinstance(prompt_lens, torch.Tensor)
        else prompt_lens)]
    with loop.lock, graphs.on_stream(loop.stream):
        st = loop.st
        if isinstance(loop.top_p, torch.Tensor):
            loop.top_p.fill_(top_p)
        if loop.log_mp is not None:
            loop.log_mp.copy_(log_min_p(min_p, dev))
        keys = _row_keys(rngs, B)
        plens = torch.tensor(plens_host, dtype=torch.int32).to(dev)
        logits0, _ = prefill_ragged(params, prompt, plens, cfg, st["cache"],
                                    tp)

        cols = torch.arange(max_len, device=dev)[None]
        buf = torch.full((B, max_len), pad_id, dtype=torch.int32, device=dev)
        buf[:, :P] = torch.where(cols[:, :P] < plens[:, None], prompt, pad_id)
        st["temps"].fill_(float(temperature))
        keys, subs = prng.split_rows(keys)
        last_logits = logits0[torch.arange(B, device=dev), (plens - 1).long()]
        counts = st.get("counts")
        if counts is not None:
            counts.copy_(token_counts(prompt, cols[:, :P] < plens[:, None],
                                      cfg.vocab_size))
            st["pen"].copy_(penalty_tensor(penalties, dev))
        last_logits = apply_no_repeat_ngram(last_logits, buf, plens, ngram,
                                            mask_value)
        if gram is not None:
            st["gstate"].copy_(scan_prompt_state(gram, prompt, plens))
            last_logits = grammar_mask(last_logits, st["gstate"], gram,
                                       budget_left=max_len - plens)
        first = sample_rows(last_logits, st["temps"], top_k, mask_value,
                            greedy, loop.top_p, min_p,
                            gumbel=None if greedy
                            else draw_noise(subs, cfg.vocab_size, dev),
                            log_mp=loop.log_mp, counts=counts,
                            penalties=st.get("pen"))
        # a row whose prompt fills the buffer starts done and keeps its
        # last prompt token
        active0 = plens < max_len
        if counts is not None:
            count_tokens(counts, first, active0)
        if gram is not None:
            st["gstate"].copy_(grammar_step(st["gstate"], first, gram,
                                            active=active0))
        hit0 = (cols == plens[:, None]) & active0[:, None]
        st["buf"].copy_(torch.where(hit0, first[:, None].to(torch.int32),
                                    buf))
        st["pos"].copy_(torch.where(active0, plens + 1, plens))
        st["last"].copy_(first)
        st["done"].copy_((first == eos_id) | ~active0)
        # steps the shortest row can take
        left = max(max_len - 1 - min(plens_host), 0)
        block = loop.block
        n_blocks = -(-left // block)
        block_keys = None
        for b in range(n_blocks):
            n = min(block, left - b * block)
            if not greedy and block_keys is None:
                keys, block_keys = prng.split_rows_chain(keys, n)
            if b > 0 and bool(st["done"].all()):
                break                          # one look a block
            loop.graph.run(block_keys)
            block_keys = None
            if not greedy and b + 1 < n_blocks:
                # the next block's keys, on the host while this one runs
                n = min(block, left - (b + 1) * block)
                keys, block_keys = prng.split_rows_chain(keys, n)
        return st["buf"].clone(), torch.clamp(st["pos"], max=max_len)
