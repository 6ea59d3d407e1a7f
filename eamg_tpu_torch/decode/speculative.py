"""Speculative decoding: proposals verified by one block forward, with
Leviathan acceptance. ``generate_prompt_lookup`` proposes from the
sequence's own history; ``decode/medusa.py`` from the Medusa heads. Both
run the verify loop of this module.

Port of ``eamg_tpu/decode/speculative.py`` (``_dist`` and
``generate_prompt_lookup``). The JAX package runs each generator as one
``lax.while_loop`` of verify iterations. Here the iterations run over a
state on the device (:class:`SpecLoop`): ``k_verifies`` of them a chunk,
one replay of a CUDA graph on the card (eagerly on the CPU), and the host
reads one packed copy a chunk, the buffer, the position and the done
flag, as ``medusa_stream_chunk`` returns them. A one-shot generator
replays chunks until its request is done, so it and its stream are one
program. An iteration reads no host value: the accepted count n is a
device value, and every write of an iteration is masked by it and by
whether the request still runs (``pos < max_len`` and not done), so an
iteration that JAX's ``cond`` would not have run leaves the state as it
was (its block's K/V land in cache slots past the cache length, which
nothing reads). The key chain does not depend on the data (a lookup
iteration splits the running key in three; a Medusa iteration splits it
once, then in three), so the host computes a chunk's keys and loads them
into the state (``graphs.load_keys``).

Semantics kept from the JAX package:
- batch 1, corrected causal checkpoints; ``max_len`` must leave ``gamma``
  positional rows (``n_pos >= max_len + gamma``), the cache holds
  ``max_len + gamma + 1`` slots;
- the first token: one split of the key, then ``categorical(log(dist +
  1e-30))`` of the filtered softmax (greedy: the argmax);
- a proposal of -1 (no history match) is never accepted and verifies as
  token 0; the residual of a rejection is p with the proposed token's
  mass removed, renormalised (p itself when nothing is left);
- an EOS is written and stops the request; slots past the end hold
  pad_id.

Grammar constraints, penalties and n-gram bans do not compose with
speculation (the serving pipeline refuses them, as JAX's does). Draft-model
speculation (``generate_speculative``) is not in the port yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gpt import GPTConfig, decode_block, init_kv_cache, prefill
from ..utils import prng
from . import graphs
from .sampling import filter_logits, log_min_p

# verify iterations a chunk: one graph replay and one read of the state
K_VERIFIES = 16


def _dist(logits: torch.Tensor, temperature, top_k: int, greedy: bool,
          top_p=1.0, min_p: float = 0.0,
          log_mp: torch.Tensor | None = None) -> torch.Tensor:
    """[R, V] logits -> [R, V] sampling distributions: the softmax of the
    temperature / top-k / top-p / min-p filtered logits (``sample_token``'s
    filters), or with ``greedy`` the one-hot of the argmax. The softmax is
    JAX's: exp(x - max) over its sum. ``temperature`` and ``top_p`` may be
    tensors on the device (the verify loop fills them once per request,
    and JAX traces the temperature, so this is a true division)."""
    if greedy:
        # a comparison, not one_hot: nothing here may read a host value
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        return (vocab == torch.argmax(logits, -1)[..., None]).to(
            torch.float32)
    x = filter_logits(logits, temperature, top_k, -1e10, top_p, min_p,
                      log_mp)
    e = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def _categorical_log(noise: torch.Tensor, probs: torch.Tensor):
    """``categorical(key, log(probs + 1e-30))`` with the key's Gumbel noise
    drawn ahead (``noise`` of the probabilities' shape)."""
    return torch.argmax(noise + torch.log(probs + 1e-30), dim=-1)


def _padded_prompt(prompt_ids, width: int, pad_id: int, device):
    prompt = np.full((1, width), pad_id, np.int64)
    prompt[0, :len(prompt_ids)] = prompt_ids
    return torch.from_numpy(prompt).to(device)


class SpecLoop:
    """The state on the device of one speculative decode (batch 1) for one
    graph key, the graph of a chunk of ``k_verifies`` verify iterations,
    and the running key on the host.

    ``propose`` names the proposer: ``"lookup"`` (the trailing ``ngram``
    of the buffer matched in its history) or ``"medusa"`` (the stacked
    heads ``hw`` [g, D, D], ``hb`` [g, D], f32, on the hidden state of the
    last accepted token). The state: ``cache`` (head-major, ``slack =
    max_len + gamma + 1`` slots); ``buf`` [1, slack + gamma + 1] int64,
    whose last columns only an iteration past the end could reach; ``pos``
    [1], the next write position (the cache length is pos - 1: the last
    token sits at pos - 1, not yet in the cache); ``last`` [1]; ``done``
    [1]; ``n_steps`` [1], the verify iterations run; ``h_last`` [D] (Medusa
    only); the sampling values ``temp``, ``top_p``, ``log_mp`` as in
    ``loop.SoloLoop``; ``keys`` [k_verifies, 3, 2], a chunk's keys (the
    proposal's, the acceptance's and the residual's); ``packed`` [slack +
    2], the buffer, pos and done as one copy for the host."""

    def __init__(self, params: dict, cfg: GPTConfig, propose: str,
                 max_len: int, gamma: int, k_verifies: int, top_k: int,
                 greedy: bool, top_p_on: bool, min_p_on: bool, eos_id: int,
                 pad_id: int, device, heads=None, ngram: int = 3,
                 eager: bool = False):
        assert cfg.causal and not cfg.pos_broadcast_bug, \
            "speculative decoding requires the corrected causal config"
        assert cfg.n_pos >= max_len + gamma, \
            "pos table too small for the speculative block overshoot"
        dev = torch.device(device)
        self.params, self.cfg, self.propose = params, cfg, propose
        self.max_len, self.gamma, self.k_verifies = max_len, gamma, k_verifies
        self.top_k, self.greedy, self.ngram = top_k, greedy, ngram
        self.eos_id, self.pad_id = eos_id, pad_id
        self.slack = slack = max_len + gamma + 1
        self.stream = graphs.side_stream(dev)
        self.rng = None
        self._next_keys = None

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.cache = init_kv_cache(cfg, 1, slack, device=dev)
        self.buf = zeros((1, slack + gamma + 1), torch.int64)
        self.pos = zeros((1,), torch.int64)
        self.last = zeros((1,), torch.int64)
        self.done = zeros((1,), torch.bool)
        self.n_steps = zeros((1,), torch.int64)
        self.temp = zeros((1,), torch.float32)
        self.top_p = zeros((1,), torch.float32) if top_p_on else 1.0
        self.log_mp = zeros((1,), torch.float32) if min_p_on else None
        self.keys = None if greedy else zeros((k_verifies, 3, 2),
                                              torch.int64)
        self.packed = zeros((slack + 2,), torch.int64)
        self.hw = self.hb = self.h_last = None
        if propose == "medusa":
            from .medusa import _stack_heads

            self.hw, self.hb = _stack_heads(heads, gamma, dev)
            self.h_last = zeros((cfg.d_model,), cfg.torch_dtype)
        elif propose != "lookup":
            raise ValueError(f"propose {propose!r}: 'lookup' or 'medusa'")
        self._idx = torch.arange(gamma + 1, device=dev)
        self._vocab = torch.arange(cfg.vocab_size, device=dev)
        self._hist = torch.arange(slack, device=dev)
        self.graph = graphs.BlockGraph(self._chunk, dev, eager)

    # ---------------------------------------------------------------- start

    def start(self, prompt: torch.Tensor, prompt_len: int, rng,
              temperature, top_p, min_p) -> None:
        """Prefill the [1, P] prompt bucket and sample the first token from
        its logits at ``prompt_len - 1`` with one split of ``rng``; the rest
        of the running key stays on the host (:attr:`rng`)."""
        st, cfg = self, self.cfg
        P = prompt.shape[1]
        logits0, _ = prefill(st.params, prompt, cfg, st.cache,
                             prompt_len=prompt_len)
        st.temp.fill_(float(temperature))
        if isinstance(st.top_p, torch.Tensor):
            st.top_p.fill_(float(top_p))
        if st.log_mp is not None:
            st.log_mp.copy_(log_min_p(min_p, st.log_mp.device))
        real = torch.arange(P, device=prompt.device)[None, :] < prompt_len
        st.buf.fill_(st.pad_id)
        st.buf[:, :P] = torch.where(real, prompt, st.pad_id)
        rng, sub = prng.split(rng)
        dist = _dist(logits0[0, prompt_len - 1][None], st.temp, st.top_k,
                     st.greedy, st.top_p, log_mp=st.log_mp)[0]
        if st.greedy:
            first = torch.argmax(dist)
        else:
            first = _categorical_log(
                prng.gumbel(sub, dist.shape, dist.device), dist)
        st.buf[0, prompt_len] = first
        st.last.copy_(first.reshape(1))
        st.done.copy_((first == st.eos_id).reshape(1))
        st.pos.fill_(prompt_len + 1)
        st.n_steps.zero_()
        if st.h_last is not None:
            # no hidden state exists yet for the first token: round 1
            # proposes from zeros (the acceptance keeps the output exact)
            st.h_last.zero_()
        st.rng = rng
        st._next_keys = None if st.greedy else self._chunk_keys()

    def _chunk_keys(self) -> np.ndarray:
        """The next chunk's keys from the running key, which advances."""
        keys = np.zeros((self.k_verifies, 3, 2), np.uint32)
        rng = self.rng
        for i in range(self.k_verifies):
            if self.propose == "medusa":
                rng, keys[i, 0] = prng.split(rng)
            rng, keys[i, 1], keys[i, 2] = prng.split(rng, 3)
        self.rng = rng
        return keys

    # ---------------------------------------------------------------- chunk

    def run_chunk(self) -> np.ndarray:
        """One chunk of verify iterations (one graph replay on the card);
        -> the packed [slack + 2] host copy: buf, pos, done."""
        if self.keys is not None:
            graphs.load_keys(self.keys, self._next_keys)
        self.graph.run()
        if self.keys is not None:
            self._next_keys = self._chunk_keys()   # while the card runs
        return self.packed.cpu().numpy()

    def _chunk(self) -> None:
        """``k_verifies`` iterations. The chunk's noise is drawn first, in
        one batch a kind (threefry bits depend on their key and index
        alone): the proposals' Gumbel noise [k, g, V], the acceptance's
        uniforms [k, g], the residual's Gumbel noise [k, V]."""
        if self.keys is not None:
            g, V = self.gamma, self.cfg.vocab_size
            self._gumbel_d = prng.gumbel(self.keys[:, 0], (g, V)) \
                if self.propose == "medusa" else None
            self._uniform = prng.uniform_from_bits(
                prng.bits_keys(self.keys[:, 1], (g,)))
            self._gumbel_r = prng.gumbel(self.keys[:, 2], (V,))
        for i in range(self.k_verifies):
            self._iteration(i)
        s = self.slack
        self.packed[:s].copy_(self.buf[0, :s])
        self.packed[s:s + 1].copy_(self.pos)
        self.packed[s + 1:].copy_(self.done)

    def _lookup_proposal(self) -> torch.Tensor:
        """The gamma tokens that followed the most recent earlier match of
        the trailing ``ngram`` tokens, -1 where there are none (JAX's
        ``propose``: ``ngram`` rolled copies of the buffer compared)."""
        ng, g, slack = self.ngram, self.gamma, self.slack
        buf0 = self.buf[0, :slack]
        pos = self.pos
        tpos = (pos - ng + torch.arange(ng, device=pos.device)).clamp(
            0, slack - 1)
        trail = buf0.index_select(0, tpos)                  # [ngram]
        cmp = torch.stack([torch.roll(buf0, -j) for j in range(ng)]) \
            == trail[:, None]
        match = cmp.all(0) & (self._hist < pos - ng) & (pos >= ng + 1)
        m = torch.where(match, self._hist, -1).max()
        src = m + ng + torch.arange(g, device=pos.device)
        return torch.where((m >= 0) & (src < pos),
                           buf0.index_select(0, src.clamp(0, slack - 1)), -1)

    def _filtered(self, logits):
        return _dist(logits, self.temp, self.top_k, self.greedy, self.top_p,
                     log_mp=self.log_mp)

    def _iteration(self, i: int) -> None:
        """One verify iteration over the state (JAX's ``body``: the lookup
        generator's, or ``_make_medusa_body``'s), masked off when the
        request no longer runs."""
        from .medusa import _head_logits

        st, g = self, self.gamma
        V = st.cfg.vocab_size
        active = (st.pos < st.max_len) & ~st.done            # [1]
        # the cache holds the confirmed prefix: its length follows pos,
        # which an iteration past the end leaves as it was
        st.cache["length"].copy_(st.pos - 1)
        medusa = st.propose == "medusa"
        q = None
        if medusa:
            head_lg = _head_logits(st.hw, st.hb, st.params, st.h_last)
            if st.greedy:
                d = torch.argmax(head_lg, -1)
            else:
                q = st._filtered(head_lg)                    # [g, V]
                d = _categorical_log(st._gumbel_d[i], q)
            block = torch.cat([st.last, d])
        else:
            d = st._lookup_proposal()
            block = torch.cat([st.last, d * (d >= 0)])
        logits, *h, _ = decode_block(st.params, block[None], st.cache, st.cfg,
                                     return_hidden=medusa)
        logits = logits[0]                                   # [g + 1, V]
        if medusa and st.greedy:
            # acceptance is d_k == the target's argmax, the residual its
            # argmax: no draws, as JAX's fast path
            t = torch.argmax(logits, -1)
            n = torch.cumprod((d == t[:g]).long(), 0).sum()
            t_new = t.index_select(0, n[None])[0]
        else:
            p = st._filtered(logits)                         # [g + 1, V]
            p_d = p[:g].gather(1, d.clamp(min=0)[:, None])[:, 0]
            if medusa:
                q_d = q.gather(1, d[:, None])[:, 0]
                acc = st._uniform[i] < torch.clamp(
                    p_d / q_d.clamp(min=1e-30), max=1.0)
            else:
                p_d = torch.where(d >= 0, p_d, 0.0)
                if st.greedy:
                    acc = p_d > 0.5
                else:
                    acc = st._uniform[i] < p_d
            n = torch.cumprod(acc.long(), 0).sum()
            p_n = p.index_select(0, n[None])[0]
            nq = n.clamp(max=g - 1)[None]
            if medusa:
                q_n = torch.where(n < g, q.index_select(0, nq)[0], 0.0)
            else:
                q_n = ((st._vocab == d.index_select(0, nq)) & (n < g)).to(
                    torch.float32)
            residual = (p_n - q_n).clamp(min=0.0)
            rsum = residual.sum()
            residual = torch.where(rsum > 1e-12,
                                   residual / rsum.clamp(min=1e-30), p_n)
            if st.greedy:
                t_new = torch.argmax(residual)
            else:
                t_new = _categorical_log(st._gumbel_r[i], residual)
        # the window written: d_1..d_n, t_new, pad...; cut after an EOS
        idx = st._idx
        window = torch.where(idx < n, torch.cat([d, d[-1:]]),
                             torch.where(idx == n, t_new, st.pad_id))
        e = torch.where((window == st.eos_id) & (idx <= n), idx,
                        g + 2).min()
        limit = torch.minimum(n + 1, e + 1)
        window = torch.where(idx < limit, window, st.pad_id)
        slots = st.pos + idx
        st.buf.index_copy_(1, slots, torch.where(
            active, window, st.buf[0].index_select(0, slots))[None])
        at = (limit - 1)[None]
        st.last.copy_(torch.where(active, window.index_select(0, at),
                                  st.last))
        st.done.copy_(torch.where(active, e <= n, st.done))
        if medusa:
            # the hidden state whose base head predicted the new last token:
            # its heads cover the gamma slots after it
            st.h_last.copy_(torch.where(
                active, h[0][0].index_select(0, at)[0], st.h_last))
        st.pos.add_(torch.where(active, limit, 0))
        st.n_steps.add_(active.long())


def spec_state(params: dict, cfg: GPTConfig, propose: str, max_len: int,
               gamma: int, k_verifies: int, top_k: int, greedy: bool,
               top_p, min_p, eos_id: int, pad_id: int, device, heads=None,
               ngram: int = 3, eager: bool = False) -> tuple:
    """-> (the graph key of a :class:`SpecLoop`, a function that makes
    one): what JAX's ``static_argnames`` key its jits by (cfg, max_len and
    the cache's slack, k_verifies, gamma, ngram, top_k, greedy, whether
    top-p and min-p are on), never a value a request fills in."""
    top_p_on = top_p is not None and float(top_p) < 1.0
    min_p_on = min_p is not None and float(min_p) > 0.0
    args = (cfg, propose, int(max_len), int(gamma), int(k_verifies),
            int(top_k), bool(greedy), top_p_on, min_p_on, int(eos_id),
            int(pad_id), torch.device(device))
    key = ("spec", id(params), id(heads), *args, int(ngram), bool(eager))
    return key, lambda: SpecLoop(params, *args, heads=heads, ngram=ngram,
                                 eager=eager)


def spec_chunks(st: SpecLoop, emitted: int):
    """Replay ``st``'s chunks while its request runs: a generator of the
    packed host copy after each chunk (``emitted``, the buffer's filled
    length before the first, is only used to stop early)."""
    pos, done = emitted, False
    while pos < st.max_len and not done:
        with graphs.on_stream(st.stream):
            packed = st.run_chunk()
        pos, done = int(packed[-2]), bool(packed[-1])
        yield packed


@torch.no_grad()
def run_to_end(st: SpecLoop, prompt: torch.Tensor, prompt_len: int, rng,
               temperature, top_p, min_p):
    """A one-shot generator's run on ``st``: start, then chunks until the
    request is done -> (tokens [1, max_len] int64 on the host, n_tokens,
    n_verify_steps), JAX's result."""
    with graphs.on_stream(st.stream):
        st.start(prompt, prompt_len, rng, temperature, top_p, min_p)
        done = bool(st.done.item())
    packed = None
    if not done:
        for packed in spec_chunks(st, prompt_len + 1):
            pass
    with graphs.on_stream(st.stream):
        if packed is None:
            packed = st.packed.copy_(torch.cat([
                st.buf[0, :st.slack], st.pos,
                st.done.long()])).cpu().numpy()
        n_steps = int(st.n_steps.item())
    pos = min(int(packed[-2]), st.max_len)
    buf = packed[:st.max_len].copy()
    buf[pos:] = st.pad_id
    return torch.from_numpy(buf)[None], pos, n_steps


@torch.no_grad()
def generate_prompt_lookup(params: dict, prompt: torch.Tensor,
                           prompt_len: int, rng, cfg: GPTConfig,
                           max_len: int, gamma: int = 8, ngram: int = 3,
                           temperature: float = 1.0, top_k: int = 50,
                           eos_id: int = -1, pad_id: int = 0,
                           greedy: bool = False, top_p: float = 1.0,
                           min_p: float = 0.0, eager: bool = False):
    """Draft-free speculative decoding (prompt-lookup / n-gram
    speculation): each iteration proposes the ``gamma`` tokens that
    followed the most recent earlier occurrence of the trailing ``ngram``
    tokens and verifies them in one block forward. The proposal is a point
    mass, so a proposal is accepted with probability p(d) (greedy: iff it
    is the target's argmax); the output distribution is the target's, and
    greedy output equals the plain greedy decode.

    prompt [1, P] (a bucket, on the params' device), ``rng`` a
    ``prng.PRNGKey``. -> (tokens [1, max_len] int64 on the host, n_tokens,
    n_verify_steps). ``eager=True`` issues every iteration from the host
    instead of replaying graphs, to compare the two."""
    assert ngram >= 1 and gamma >= 1
    assert prompt.shape[0] == 1, \
        "prompt-lookup decoding is a batch-1 latency optimization"
    key, make = spec_state(params, cfg, "lookup", max_len, gamma, K_VERIFIES,
                           top_k, greedy, top_p, min_p, eos_id, pad_id,
                           prompt.device, ngram=ngram, eager=eager)
    with graphs.pooled(key, make) as st:
        return run_to_end(st, prompt, prompt_len, rng, temperature, top_p,
                          min_p)

