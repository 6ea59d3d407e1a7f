"""Generation loops: ``generate_kv`` (prefill, then one ``decode_step``
per token) and ``generate_full`` (the uncached loop over ``forward``).

Port of ``eamg_tpu/decode/loop.py``. The JAX package runs ``generate_kv``
as one compiled ``while_loop``; here the decode lives in a state on the
device (``decode/graphs.py``), for any batch of rows of one prompt length:
prefill writes its cache in place, and then blocks of ``graphs.BLOCK``
steps run, each replayed on the card from one CUDA graph (eagerly on the CPU).
A step reads no host value: its position, its count of inert steps and
the rows' flags are device tensors, its noise is drawn inside the graph
from the block's keys. As JAX's loop does, the decode stops at the first
step where every row is done: the steps of the block after it are inert
(they write pad_id, and are counted, so that the result is JAX's ``(buf,
pos)``), and the host looks once a block, where the JAX loop's predicate
looks every step. ``generate_full`` (the uncached ablation) issues its steps from the
host and looks at the flags every step. ``attn_impl`` names the decode
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
  too when ``refeed_last_prompt=False``. Both act in greedy mode as well;
- ``grammar`` (``decode/grammar.py``) masks after the n-gram ban and
  before the sampler, with the tokens left, ``max_len - pos``, as its
  budget; its state starts from the prompt and a finished row's holds.

``generate_kv(..., tp=)`` decodes on tensor-parallel params (every rank of
the model group runs it with its blocks, ``parallel/mesh.py::
shard_params(tp=True)``): each rank's prefill and steps run K1, K2 and K3
on its heads and FF columns, the out-projection and K2's partial sums are
summed over the group (K2's ``b2`` added once, after the sum), and the
logits are gathered whole before the sampler (K4 sees every row whole),
so every rank samples the same stream, the unsharded one. A group of more
than one rank issues its steps from the host (no collective inside a
captured graph); a group of one keeps its graphs. ``generate_full(...,
tp=)`` re-encodes the prefix through ``forward_masked(..., tp=)``, the
same way.
"""

from __future__ import annotations

import threading

import torch

from ..models.gpt import (GPTConfig, cache_layout, decode_step,
                          forward_masked, init_kv_cache, prefill)
from ..utils import prng
from ..utils.logging import span
from . import graphs
from .grammar import (grammar_mask, grammar_step, grammar_tables,
                      scan_prompt_state)
from .sampling import (apply_no_repeat_ngram, count_tokens, log_min_p,
                       penalties_on, penalty_tensor, sample_token,
                       token_counts)


def _key_blocks(rng, pos0: int, max_len: int, presplit: bool, block: int):
    """The sampling keys of the steps pos0..max_len - 1, ``block`` at a
    time, each a list of (uint32, uint32) pairs: from ``split`` of the
    running key, or with ``presplit`` ``split(rng, max_len)[pos]``."""
    for start in range(pos0, max_len, block):
        stop = min(start + block, max_len)
        if presplit:
            yield prng.split_range(rng, start, stop)
            continue
        keys = []
        for _ in range(start, stop):
            rng, sub = prng.split(rng)
            keys.append(sub)
        yield keys


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


class SoloLoop:
    """The state on the device of a solo decode (``generate_kv`` and the
    streamed decode of ``decode/stream.py``) for one graph key, and the
    graph of a block of its steps. Every tensor keeps its address across
    requests; a request refills the values (:func:`_begin`).

    ``cache`` holds ``slots`` positions (``max_len`` unless given; the
    stream's holds ``max_len + chunk``, as JAX's does); ``buf`` [B,
    max_len + 1] int64: the token buffer and a last column
    that the steps after ``max_len`` write into (the block's overrun,
    dropped); ``pos`` [1] int64: the next write position; ``inert`` [1]
    int64: the steps run after every row was done, which JAX's loop would
    not have run (its predicate, the stop position, is then ``pos0`` plus
    the steps run less these); ``done`` [B], ``last`` [B]; ``counts``
    [B, V] with penalties on; the sampling values ``temp`` [1], ``top_p``
    [1], ``log_mp`` [1], ``pen`` [3] (None, or 1.0 for top_p, when off: a
    filter that is off is not in the graph); ``gram``: the grammar's tables
    on the device (``Grammar.arrays``, captured by address) and ``gstate``
    [B] its states, or None; ``keys`` [block, 2] int64, the block's step
    keys."""

    def __init__(self, params: dict, cfg: GPTConfig, batch: int,
                 max_len: int, device, attn_impl: str, top_k: int,
                 greedy: bool, mask_value: float, eos_id: int, pad_id: int,
                 top_p_on: bool, min_p_on: bool, pen_on: bool, ngram: int,
                 gram: dict | None = None, block: int = graphs.BLOCK,
                 slots: int | None = None, eager: bool = False,
                 capture_error_mode: str = "thread_local", tp=None):
        dev = torch.device(device)
        self.params, self.cfg, self.max_len = params, cfg, max_len
        self.tp = tp
        self.attn_impl, self.top_k, self.greedy = attn_impl, top_k, greedy
        self.mask_value, self.eos_id, self.pad_id = mask_value, eos_id, pad_id
        self.ngram, self.block, self.gram = ngram, block, gram
        self.lock = threading.Lock()
        self.stream = graphs.side_stream(dev)
        B, V = batch, cfg.vocab_size

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.cache = init_kv_cache(cfg, B, slots or max_len, device=dev,
                                   layout=cache_layout(attn_impl, cfg),
                                   tp=tp)
        self.buf = zeros((B, max_len + 1), torch.int64)
        self.tokens = self.buf[:, :max_len]
        self.pos = zeros((1,), torch.int64)
        self.inert = zeros((1,), torch.int64)
        self.done = zeros((B,), torch.bool)
        self.last = zeros((B,), torch.int64)
        self.counts = zeros((B, V), torch.float32) if pen_on else None
        self.temp = zeros((1,), torch.float32)
        self.top_p = zeros((1,), torch.float32) if top_p_on else 1.0
        self.log_mp = zeros((1,), torch.float32) if min_p_on else None
        self.pen = zeros((3,), torch.float32) if pen_on else None
        self.gstate = None if gram is None else zeros((B,), torch.int64)
        self.keys = None if greedy else zeros((block, 2), torch.int64)
        self.graph = graphs.BlockGraph(self._block, dev, eager,
                                       capture_error_mode)

    def _block(self) -> None:
        """``block`` decode steps over the state, in place."""
        B, L = self.buf.shape[0], self.max_len
        track_eos = self.eos_id >= 0
        noise = None if self.greedy else prng.gumbel(
            self.keys, (B, self.cfg.vocab_size))          # [block, B, V]
        for i in range(self.block):
            if track_eos:
                self.inert.add_(self.done.all())
            logits, _ = decode_step(self.params, self.last[:, None],
                                    self.cache, self.cfg, self.attn_impl,
                                    tp=self.tp)
            logits = apply_no_repeat_ngram(logits, self.tokens, self.pos,
                                           self.ngram, self.mask_value)
            if self.gram is not None:
                logits = grammar_mask(logits, self.gstate, self.gram,
                                      budget_left=L - self.pos)
            nxt = sample_token(None, logits, self.temp, self.top_k,
                               self.mask_value, self.greedy, self.top_p,
                               gumbel=None if self.greedy else noise[i],
                               counts=self.counts, penalties=self.pen,
                               log_mp=self.log_mp)
            if self.counts is not None:
                count_tokens(self.counts, nxt, ~self.done)
            if self.gram is not None:
                self.gstate.copy_(grammar_step(self.gstate, nxt, self.gram,
                                               active=~self.done))
            write = nxt
            if track_eos:
                write = torch.where(self.done, self.pad_id, nxt)
                torch.logical_or(self.done, nxt == self.eos_id,
                                 out=self.done)
            self.buf.index_copy_(1, self.pos.clamp(max=L), write[:, None])
            self.last.copy_(nxt)
            self.pos.add_(1)


def solo_state(params: dict, cfg: GPTConfig, batch: int, max_len: int,
               device, attn_impl: str, top_k: int, greedy: bool,
               mask_value: float, eos_id: int, pad_id: int, top_p, min_p,
               penalties, no_repeat_ngram: int, block: int,
               slots: int | None = None, eager: bool = False,
               capture_error_mode: str = "thread_local",
               grammar=None, tp=None) -> tuple:
    """-> (the graph key of a :class:`SoloLoop`, a function that makes
    one). The key holds what fixes the shapes and the code of a step, as
    JAX's ``static_argnames`` do, never a value that a request fills in;
    with a grammar, its tables' identity (a graph reads them by address,
    so one scheme's graph never replays another's tables)."""
    top_p_on = top_p is not None and float(top_p) < 1.0
    min_p_on = min_p is not None and float(min_p) > 0.0
    cache_layout(attn_impl, cfg)                 # refuse a bad name first
    gram = grammar_tables(grammar, device)
    args = (cfg, int(batch), int(max_len), torch.device(device), attn_impl,
            int(top_k), bool(greedy), float(mask_value), int(eos_id),
            int(pad_id), top_p_on, min_p_on, bool(_penalty_args(penalties)),
            int(no_repeat_ngram or 0))
    key = ("solo", id(params), *args, int(block), slots, bool(eager),
           None if gram is None else id(gram), id(tp))
    return key, lambda: SoloLoop(params, *args, gram=gram, block=int(block),
                                 slots=slots, eager=eager,
                                 capture_error_mode=capture_error_mode,
                                 tp=tp)


@torch.no_grad()
def generate_kv(params: dict, prompt: torch.Tensor, prompt_len: int, rng,
                cfg: GPTConfig, max_len: int, temperature: float = 1.0,
                top_k: int = 50, eos_id: int = -1, pad_id: int = 0,
                greedy: bool = False, refeed_last_prompt: bool = True,
                mask_value: float = -1e10, presplit_keys: bool = False,
                top_p: float = 1.0, min_p: float = 0.0,
                penalties: tuple | None = None, no_repeat_ngram: int = 0,
                grammar=None, attn_impl: str = "sp", eager: bool = False,
                capture_error_mode: str = "thread_local", tp=None):
    """prompt [B, P] (padded to a bucket P, on the params' device),
    prompt_len real tokens in every row, rng a ``prng.PRNGKey``.
    ``penalties``: (repetition, frequency, presence) or None;
    ``no_repeat_ngram``: the banned n-gram size, 0 for none; ``grammar``: a
    ``decode.grammar.Grammar`` (or its ``arrays``) or None; ``attn_impl``:
    one of ``models.gpt.ATTN_IMPLS``. Returns (tokens [B, max_len] int64
    on the device, n_tokens int), JAX's ``(buf, pos)``; slots at or past
    n_tokens hold pad_id. On the card the steps replay CUDA graphs
    (:class:`SoloLoop`); ``eager=True`` issues them from the host instead,
    to compare the two (no served path passes it). A key's first call
    captures its graph in ``capture_error_mode`` (``torch.cuda.graph``'s;
    ``"global"`` fails on any host sync in a step, from any thread).
    ``tp``: a ``parallel.collectives.TensorParallel`` and ``params`` this
    rank's blocks (the module's docstring)."""
    B, P = prompt.shape
    eager = eager or graphs.on_group(tp)
    assert cfg.pos_broadcast_bug or max_len <= cfg.n_pos, (
        f"max_len={max_len} exceeds the positional table "
        f"(n_pos={cfg.n_pos}); cap decode length at cfg.n_pos")
    key, make = solo_state(params, cfg, B, max_len, prompt.device, attn_impl,
                           top_k, greedy, mask_value, eos_id, pad_id, top_p,
                           min_p, penalties, no_repeat_ngram, graphs.BLOCK,
                           eager=eager, capture_error_mode=capture_error_mode,
                           grammar=grammar, tp=tp)
    st = graphs.state_for(key, make)
    with st.lock, graphs.on_stream(st.stream):
        pos0, keys = _begin(st, prompt, prompt_len, rng, temperature, top_p,
                            min_p, penalties, refeed_last_prompt,
                            presplit_keys)
        run = 0
        for run, _ in enumerate(_blocks(st, pos0, keys), 1):
            pass
        tokens = st.tokens.clone()
        return tokens, min(pos0 + run * st.block - int(st.inert.item()),
                           max_len)


def _begin(st: SoloLoop, prompt, prompt_len: int, rng, temperature, top_p,
           min_p, penalties, refeed: bool, presplit: bool) -> tuple:
    """The start of one request on ``st``: prefill into its cache and the
    start of the loop written into its state. Without ``refeed`` the first
    token is sampled from the prefill logits with one split of ``rng``
    (``refeed_last_prompt=False``, and JAX's stream), masked by the grammar
    with ``max_len - prompt_len`` tokens left. -> (the position the first
    block writes, the blocks' step keys: :func:`_key_blocks`, None when
    greedy)."""
    cfg, max_len = st.cfg, st.max_len
    B, P = prompt.shape
    logits0, _ = prefill(st.params, prompt, cfg, st.cache,
                         prompt_len=prompt_len, tp=st.tp)
    real = torch.arange(P, device=prompt.device)[None, :] < prompt_len
    st.buf.fill_(st.pad_id)
    st.buf[:, :P] = torch.where(real, prompt, st.pad_id)
    if st.counts is not None:
        st.counts.copy_(token_counts(prompt, real.expand(B, P),
                                     cfg.vocab_size))
        st.pen.copy_(penalty_tensor(penalties, st.pen.device))
    st.temp.fill_(float(temperature))
    if isinstance(st.top_p, torch.Tensor):
        st.top_p.fill_(float(top_p))
    if st.log_mp is not None:
        st.log_mp.copy_(log_min_p(min_p, st.log_mp.device))
    st.done.zero_()
    if st.gram is not None:
        st.gstate.copy_(scan_prompt_state(st.gram, prompt, prompt_len))
    if refeed:
        st.last.copy_(prompt[:, prompt_len - 1])
        pos0, rng0 = prompt_len, rng
    else:
        rng0, sub = prng.split(rng)
        last_logits = apply_no_repeat_ngram(
            logits0[:, prompt_len - 1], st.tokens, prompt_len, st.ngram,
            st.mask_value)
        if st.gram is not None:
            last_logits = grammar_mask(last_logits, st.gstate, st.gram,
                                       budget_left=max_len - prompt_len)
        first = sample_token(sub, last_logits, st.temp, st.top_k,
                             st.mask_value, st.greedy, st.top_p,
                             counts=st.counts, penalties=st.pen,
                             log_mp=st.log_mp)
        st.buf[:, prompt_len] = first
        st.done.copy_(first == st.eos_id)
        st.last.copy_(first)
        pos0 = prompt_len + 1
        if st.counts is not None:
            count_tokens(st.counts, first, torch.ones_like(st.done))
        if st.gram is not None:
            st.gstate.copy_(grammar_step(st.gstate, first, st.gram))
    st.pos.fill_(pos0)
    st.inert.zero_()
    keys = None if st.greedy else _key_blocks(rng0, pos0, max_len, presplit,
                                             st.block)
    return pos0, keys


def _blocks(st: SoloLoop, pos0: int, keys, emit: bool = False):
    """Replay one request's blocks on ``st``: a generator of one item a
    block, after its replay. With ``emit`` the item is the block's tokens
    before ``max_len`` and then the inert count, [B, n + 1] on the host in
    one copy; else None. It looks at the state once a block (not after the
    last one, nor when no row can end) and stops once every row is done.
    Spans: ``decode.block`` (the replay's issue), ``decode.block_flags``
    (the host's wait for the block's flags)."""
    B, L = st.buf.shape[0], st.max_len
    n_blocks = max(-(-(L - pos0) // st.block), 0)
    block_keys = next(keys) if keys is not None and n_blocks else None
    for run in range(n_blocks):
        last = run + 1 == n_blocks
        with span("decode.block", rows=B, steps=st.block):
            if keys is not None:
                graphs.load_keys(st.keys, block_keys)
            st.graph.run()
            if keys is not None and not last:
                block_keys = next(keys)        # on the host, while it runs
        host = None
        if emit:
            start = pos0 + run * st.block
            with span("decode.block_flags") as sp:
                host = torch.cat((st.buf[:, start:min(start + st.block, L)],
                                  st.inert.expand(B, 1)), 1).cpu().numpy()
                sp.count(inert=int(host[0, -1]))
        yield host
        if last or st.eos_id < 0:
            continue
        if emit:
            inert = int(host[0, -1])
        else:
            with span("decode.block_flags") as sp:
                inert = int(st.inert.item())
                sp.count(inert=inert)
        if inert > 0:
            return                             # every row is done


@torch.no_grad()
def generate_full(params: dict, prompt: torch.Tensor, prompt_len: int, rng,
                  cfg: GPTConfig, max_len: int, temperature: float = 1.0,
                  top_k: int = 50, eos_id: int = -1, pad_id: int = 0,
                  greedy: bool = False, mask_value: float = -1e10,
                  top_p: float = 1.0, min_p: float = 0.0,
                  penalties: tuple | None = None, no_repeat_ngram: int = 0,
                  grammar=None, tp=None):
    """Uncached generation (the reference's ``sample()``): every step
    re-encodes the whole prefix through ``forward_masked`` at one shape,
    [B, max_len - 1] with the first ``pos`` positions valid. Arguments and
    result as :func:`generate_kv` (``tp`` too); a key is split off every
    step, and the loop looks at the rows' done flags every step. The
    temperature and the penalties go to the sampler as tensors on the
    device, filled once: JAX traces them, so it divides by them, where a
    division by a host float is a multiply by its reciprocal on CUDA."""
    B = prompt.shape[0]
    dev = prompt.device
    T = max_len - 1   # the reference never re-encodes the final token
    pen = _penalty_args(penalties)
    ngram = int(no_repeat_ngram or 0)
    buf, counts = _start(prompt, prompt_len, max_len, pad_id, cfg.vocab_size,
                         pen)
    temp = torch.full((1,), float(temperature), dtype=torch.float32,
                      device=dev)
    pen_t = penalty_tensor(penalties, dev) if pen else None
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    gram = grammar_tables(grammar, dev)
    gstate = None if gram is None else scan_prompt_state(gram, prompt,
                                                         prompt_len)
    pos = prompt_len
    while pos < max_len and not bool(done.all()):
        rng, sub = prng.split(rng)
        logits = forward_masked(params, buf[:, :T], cfg, valid_len=pos,
                                tp=tp)
        last_logits = apply_no_repeat_ngram(logits[:, pos - 1], buf, pos,
                                            ngram, mask_value)
        if gram is not None:
            last_logits = grammar_mask(last_logits, gstate, gram,
                                       budget_left=max_len - pos)
        nxt = sample_token(sub, last_logits, temp, top_k, mask_value,
                           greedy, top_p, min_p, counts=counts,
                           penalties=pen_t)
        if pen:
            counts = count_tokens(counts, nxt, ~done)
        if gram is not None:
            gstate = grammar_step(gstate, nxt, gram, active=~done)
        buf[:, pos] = torch.where(done, pad_id, nxt)
        done = done | (nxt == eos_id)
        pos += 1
    return buf, pos
