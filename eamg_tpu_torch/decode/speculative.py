"""Speculative decoding: proposals verified by one block forward, with
Leviathan acceptance. ``generate_speculative`` proposes with a draft
model, ``generate_prompt_lookup`` from the sequence's own history,
``decode/medusa.py`` from the Medusa heads and ``decode/medusa_tree.py``
from a tree of their candidates. All run the verify loop of this module.

Port of ``eamg_tpu/decode/speculative.py``. The JAX package runs each generator as one
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
once, then in three; a draft iteration gamma + 1 times, then in three),
so the host computes a chunk's keys and loads them into the state
(``graphs.load_keys``). A draft keeps a head-major cache of its own,
whose length follows pos as the target's does: its gamma + 1 steps (K3
on the card) write the proposals' K/V, the last step only syncs the
cache.

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
speculation (the serving pipeline refuses them, as JAX's does).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.gpt import (GPTConfig, decode_block, decode_step, decode_tree,
                          init_kv_cache, prefill)
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
    return _softmax(filter_logits(logits, temperature, top_k, -1e10, top_p,
                                  min_p, log_mp))


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """JAX's softmax: exp(x - max) over its sum."""
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


def medusa_verify(params: dict, cfg: GPTConfig, hw: torch.Tensor,
                  hb: torch.Tensor, h_last: torch.Tensor, last: torch.Tensor,
                  cache: dict, filt, greedy: bool, gumbel_d=None,
                  uniform=None, gumbel_r=None, tp=None):
    """One Medusa verify of one request (JAX's ``_make_medusa_body`` up to
    the window): the stacked heads ``hw``/``hb`` propose g tokens from
    ``h_last`` [D], the block [last, d_1..d_g] is verified by one
    :func:`decode_block` over ``cache`` from its length on, and Leviathan's
    acceptance (q the heads' distributions) or, greedy, the argmax chain
    picks the accepted count and the next token. ``filt`` maps [R, V]
    logits to their sampling distributions; the noise is the iteration's:
    ``gumbel_d`` [g, V], ``uniform`` [g], ``gumbel_r`` [V]. -> (d [g], n,
    t_new, h_rows [g + 1, D], logits [g + 1, V]): the block's hidden
    state h_rows[j] is the one whose base head predicts window token j.
    The solo loop and the engine's Medusa rows both verify through it.
    ``tp``: the model group, ``params`` this rank's blocks and ``cache``
    its K/V heads; the heads, hidden states and logits are whole on every
    rank, so every rank draws the same tokens."""
    from .medusa import _head_logits

    g = hw.shape[0]
    head_lg = _head_logits(hw, hb, params, h_last, tp)      # [g, V]
    q = None
    if greedy:
        d = torch.argmax(head_lg, -1)
    else:
        q = filt(head_lg)                                   # [g, V]
        d = _categorical_log(gumbel_d, q)
    logits, h, _ = decode_block(params, torch.cat([last, d])[None], cache,
                                cfg, return_hidden=True, tp=tp)
    logits = logits[0]                                      # [g + 1, V]
    if greedy:
        # acceptance is d_k == the target's argmax, the residual its
        # argmax: no draws, as JAX's fast path
        t = torch.argmax(logits, -1)
        n = torch.cumprod((d == t[:g]).long(), 0).sum()
        return d, n, t.index_select(0, n[None])[0], h[0], logits
    p = filt(logits)                                        # [g + 1, V]
    p_d = p[:g].gather(1, d[:, None])[:, 0]
    q_d = q.gather(1, d[:, None])[:, 0]
    acc = uniform < torch.clamp(p_d / q_d.clamp(min=1e-30), max=1.0)
    n = torch.cumprod(acc.long(), 0).sum()
    t_new = _categorical_log(gumbel_r, _residual(
        p, torch.where(n < g, q.index_select(0, n.clamp(max=g - 1)[None])[0],
                       0.0), n))
    return d, n, t_new, h[0], logits


def _residual(p: torch.Tensor, q_n: torch.Tensor, n: torch.Tensor):
    """normalize(max(p[n] - q_n, 0)), p[n] itself when nothing is left."""
    p_n = p.index_select(0, n[None])[0]
    residual = (p_n - q_n).clamp(min=0.0)
    rsum = residual.sum()
    return torch.where(rsum > 1e-12, residual / rsum.clamp(min=1e-30), p_n)


class SpecLoop:
    """The state on the device of one speculative decode (batch 1) for one
    graph key, the graph of a chunk of ``k_verifies`` verify iterations,
    and the running key on the host.

    ``propose`` names the proposer: ``"lookup"`` (the trailing ``ngram``
    of the buffer matched in its history), ``"medusa"`` (the stacked
    heads ``hw`` [g, D, D], ``hb`` [g, D], f32, on the hidden state of the
    last accepted token), ``"draft"`` (a draft model's ``gamma`` sampled
    steps: ``draft`` is its (params, cfg, tp), with a head-major cache of
    its own) or ``"tree"`` (greedy only: the heads' top-b candidates arranged
    as the tree ``tree``, verified by one tree-attention forward,
    ``decode/medusa_tree.py``). The state: ``cache`` (head-major, ``slack
    = max_len + gamma + 1`` slots, ``max_len + N + 1`` for a tree of N
    nodes); ``buf`` [1, slack + gamma + 1] int64, whose last columns only
    an iteration past the end could reach; ``pos`` [1], the next write
    position (the cache length is pos - 1: the last token sits at pos - 1,
    not yet in the cache); ``last`` [1]; ``done`` [1]; ``n_steps`` [1], the
    verify iterations run; ``h_last`` [D] (Medusa and tree); the sampling
    values ``temp``, ``top_p``, ``log_mp`` as in ``loop.SoloLoop``;
    ``keys`` [k_verifies, n_keys, 2], a chunk's keys (the proposals', then
    the acceptance's and the residual's); ``packed`` [slack + 2], the
    buffer, pos and done as one copy for the host.

    ``tp``: a ``parallel.collectives.TensorParallel`` and ``params`` this
    rank's blocks; the caches hold its K/V heads, and every rank of the
    group runs the same loop (the hidden states, the logits and so the
    tokens and the host's reads are whole and the same on every rank). A
    draft is on the same group (its own ``tp``) or whole on every rank
    (``tp`` None: every rank runs the same draft steps on the same keys).
    On a group of more than one rank the iterations are issued from the
    host (``graphs.on_group``), and a chunk stops at the first iteration
    after the request ended; a group of one keeps its graphs."""

    def __init__(self, params: dict, cfg: GPTConfig, propose: str,
                 max_len: int, gamma: int, k_verifies: int, top_k: int,
                 greedy: bool, top_p_on: bool, min_p_on: bool, eos_id: int,
                 pad_id: int, device, heads=None, ngram: int = 3,
                 eager: bool = False, draft: tuple | None = None,
                 tree: tuple | None = None, tp=None):
        assert cfg.causal and not cfg.pos_broadcast_bug, \
            "speculative decoding requires the corrected causal config"
        dev = torch.device(device)
        self.params, self.cfg, self.propose = params, cfg, propose
        self.tp = tp
        self.max_len, self.k_verifies = max_len, k_verifies
        self.top_k, self.greedy, self.ngram = top_k, greedy, ngram
        self.eos_id, self.pad_id = eos_id, pad_id
        self.stream = graphs.side_stream(dev)
        self.rng = None
        self._next_keys = None
        self.tables = None
        if propose == "tree":
            from .medusa_tree import tree_tables

            assert greedy, "tree verification is greedy only"
            tb = tree_tables(tree)
            gamma = tb["gamma"]
            self.tables = {k: torch.as_tensor(tb[k]).to(dev).long()
                           if tb[k].dtype != np.bool_
                           else torch.as_tensor(tb[k]).to(dev)
                           for k in ("parent", "head", "rank", "depth", "anc",
                                     "chain")}
            self.b_max, n_heads = tb["b_max"], tb["n_heads"]
            slack = max_len + tb["N"] + 1
        else:
            slack = max_len + gamma + 1
        assert cfg.n_pos >= max_len + gamma, \
            "pos table too small for the speculative block overshoot"
        self.gamma, self.slack = gamma, slack

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.cache = init_kv_cache(cfg, 1, slack, device=dev, tp=tp)
        self.buf = zeros((1, slack + gamma + 1), torch.int64)
        self.pos = zeros((1,), torch.int64)
        self.last = zeros((1,), torch.int64)
        self.done = zeros((1,), torch.bool)
        self.n_steps = zeros((1,), torch.int64)
        self.temp = zeros((1,), torch.float32)
        self.top_p = zeros((1,), torch.float32) if top_p_on else 1.0
        self.log_mp = zeros((1,), torch.float32) if min_p_on else None
        n_keys = gamma + 2 if propose == "draft" else 3
        self.keys = None if greedy else zeros((k_verifies, n_keys, 2),
                                              torch.int64)
        self.packed = zeros((slack + 2,), torch.int64)
        self.hw = self.hb = self.h_last = None
        self.draft = self.draft_cache = None
        if propose in ("medusa", "tree"):
            from .medusa import _stack_heads

            self.hw, self.hb = _stack_heads(
                heads, gamma if propose == "medusa" else n_heads, dev)
            self.h_last = zeros((cfg.d_model,), cfg.torch_dtype)
        elif propose == "draft":
            params_d, cfg_d, tp_d = draft
            assert cfg_d.causal and not cfg_d.pos_broadcast_bug
            assert cfg_d.n_pos >= max_len + gamma
            self.draft = draft
            self.draft_cache = init_kv_cache(cfg_d, 1, slack, device=dev,
                                             tp=tp_d)
        elif propose != "lookup":
            raise ValueError(f"propose {propose!r}: 'lookup', 'medusa', "
                             "'draft' or 'tree'")
        self._idx = torch.arange(gamma + 1, device=dev)
        self._vocab = torch.arange(cfg.vocab_size, device=dev)
        self._hist = torch.arange(slack, device=dev)
        # a loop issued from the host on a group stops where JAX's loop
        # stops: an iteration after it changes nothing and would cost the
        # group its collectives
        self.on_group = graphs.on_group(tp, None if draft is None
                                        else draft[2])
        self.graph = graphs.BlockGraph(self._chunk, dev,
                                       eager or self.on_group)

    # ---------------------------------------------------------------- start

    def start(self, prompt: torch.Tensor, prompt_len: int, rng,
              temperature, top_p, min_p) -> None:
        """Prefill the [1, P] prompt bucket (the draft's too) and sample
        the first token from the target's logits at ``prompt_len - 1`` with
        one split of ``rng``; the rest of the running key stays on the
        host (:attr:`rng`)."""
        st, cfg = self, self.cfg
        P = prompt.shape[1]
        logits0, _ = prefill(st.params, prompt, cfg, st.cache,
                             prompt_len=prompt_len, tp=st.tp)
        if st.draft is not None:
            prefill(st.draft[0], prompt, st.draft[1], st.draft_cache,
                    prompt_len=prompt_len, tp=st.draft[2])
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
        """The next chunk's keys from the running key, which advances: a
        Medusa iteration splits it once (the proposal), a draft iteration
        gamma + 1 times (a draft step each; the cache-sync step's key is
        unused), then every iteration splits it in three (acceptance and
        residual)."""
        keys = np.zeros(tuple(self.keys.shape), np.uint32)
        rng = self.rng
        for i in range(self.k_verifies):
            if self.propose == "medusa":
                rng, keys[i, 0] = prng.split(rng)
            elif self.propose == "draft":
                for j in range(self.gamma + 1):
                    rng, sub = prng.split(rng)
                    if j < self.gamma:
                        keys[i, j] = sub
            rng, keys[i, -2], keys[i, -1] = prng.split(rng, 3)
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
        alone): the proposals' Gumbel noise [k, g, V] (Medusa: one key for
        all g; draft: a key a step), the acceptance's uniforms [k, g], the
        residual's Gumbel noise [k, V]."""
        if self.keys is not None:
            g, V = self.gamma, self.cfg.vocab_size
            k = self.k_verifies
            self._gumbel_d = None
            if self.propose == "medusa":
                self._gumbel_d = prng.gumbel(self.keys[:, 0], (g, V))
            elif self.propose == "draft":
                self._gumbel_d = prng.gumbel(
                    self.keys[:, :g].reshape(k * g, 2), (V,)).reshape(k, g, V)
            self._uniform = prng.uniform_from_bits(
                prng.bits_keys(self.keys[:, -2], (g,)))
            self._gumbel_r = prng.gumbel(self.keys[:, -1], (V,))
        for i in range(self.k_verifies):
            if self.on_group and not bool(
                    ((self.pos < self.max_len) & ~self.done).item()):
                break
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

    def _noise(self, i: int):
        if self.keys is None:
            return None, None, None
        return self._gumbel_d[i] if self._gumbel_d is not None else None, \
            self._uniform[i], self._gumbel_r[i]

    def _medusa(self, i: int):
        d, n, t_new, h_rows, _ = medusa_verify(
            self.params, self.cfg, self.hw, self.hb, self.h_last, self.last,
            self.cache, self._filtered, self.greedy, *self._noise(i),
            tp=self.tp)
        return d, n, t_new, h_rows

    def _lookup(self, i: int):
        st, g = self, self.gamma
        d = st._lookup_proposal()
        logits, _ = decode_block(st.params, torch.cat([st.last, d * (d >= 0)])
                                 [None], st.cache, st.cfg, tp=st.tp)
        p = st._filtered(logits[0])                          # [g + 1, V]
        p_d = torch.where(d >= 0, p[:g].gather(1, d.clamp(min=0)[:, None])
                          [:, 0], 0.0)
        acc = p_d > 0.5 if st.greedy else st._uniform[i] < p_d
        n = torch.cumprod(acc.long(), 0).sum()
        q_n = ((st._vocab == d.index_select(0, n.clamp(max=g - 1)[None]))
               & (n < g)).to(torch.float32)
        residual = _residual(p, q_n, n)
        t_new = torch.argmax(residual) if st.greedy else \
            _categorical_log(st._gumbel_r[i], residual)
        return d, n, t_new, None

    def _draft(self, i: int):
        """gamma + 1 draft steps (the last only writes d_gamma's K/V into
        the draft's cache), then one target verify of [last, d_1..d_g]."""
        st, g = self, self.gamma
        params_d, cfg_d, tp_d = st.draft
        gumbel_d = st._gumbel_d[i] if st.keys is not None else None
        cur, toks, qs = st.last, [], []
        for j in range(g + 1):
            logits_d, _ = decode_step(params_d, cur[None], st.draft_cache,
                                      cfg_d, tp=tp_d)
            if j < g:
                if st.greedy:
                    cur = torch.argmax(logits_d, -1)
                else:
                    q = st._filtered(logits_d)[0]
                    qs.append(q)
                    cur = _categorical_log(gumbel_d[j], q)[None]
                toks.append(cur)
        d = torch.cat(toks)                                  # [g]
        logits, _ = decode_block(st.params, torch.cat([st.last, d])[None],
                                 st.cache, st.cfg, tp=st.tp)
        logits = logits[0]                                   # [g + 1, V]
        if st.greedy:
            # one-hot p and q: accepted while d is the target's argmax, the
            # next token the target's argmax
            t = torch.argmax(logits, -1)
            n = torch.cumprod((d == t[:g]).long(), 0).sum()
            return d, n, t.index_select(0, n[None])[0], None
        q = torch.stack(qs)                                  # [g, V]
        p = st._filtered(logits)
        p_d = p[:g].gather(1, d[:, None])[:, 0]
        q_d = q.gather(1, d[:, None])[:, 0]
        acc = st._uniform[i] < torch.clamp(p_d / q_d.clamp(min=1e-30),
                                           max=1.0)
        n = torch.cumprod(acc.long(), 0).sum()
        q_n = torch.where(n < g, q.index_select(0, n.clamp(max=g - 1)[None])
                          [0], 0.0)
        return d, n, _categorical_log(st._gumbel_r[i],
                                      _residual(p, q_n, n)), None

    def _tree(self, i: int):
        """The heads' top-b candidates as the tree's nodes, one
        tree-attention verify, the deepest path whose every node is the
        base argmax at its parent, and the commit of its K/V to the slots
        after the root's."""
        from .medusa import _head_logits
        from .medusa_tree import _top_b

        st, g, tb = self, self.gamma, self.tables
        cand = _top_b(_head_logits(st.hw, st.hb, st.params, st.h_last,
                                   st.tp), st.b_max)         # [heads, b]
        tok = torch.cat([st.last, cand[tb["head"][1:], tb["rank"][1:]]])
        N = tok.shape[0]
        logits, h_block, _ = decode_tree(st.params, tok[None], tb["depth"],
                                         tb["anc"], st.cache, st.cfg,
                                         tp=st.tp)
        t_pred = torch.argmax(logits[0], -1)                 # [N]
        matched = tok == t_pred.index_select(0, tb["parent"])
        # a node is on an accepted path when it and each of its ancestors
        # but the root matched
        nodes = torch.arange(N, device=tok.device)
        ok = ~(tb["anc"] & ~matched[None, :] & (nodes != 0)[None, :]).any(-1)
        score = torch.where(ok, tb["depth"], -1)
        n = score.max()                                      # accepted depth
        best = torch.argmax(score)                           # one a depth
        bonus = t_pred.index_select(0, best[None])[0]
        chain_b = tb["chain"].index_select(0, best[None])[0]  # [g]
        path = tok.index_select(0, chain_b)                  # [g]
        # the node whose hidden state predicts window token j: the path's
        # node at depth j + 1 while j < n, the accepted node at j = n
        nodes_w = torch.where(st._idx >= n, best,
                              torch.cat([chain_b, chain_b[-1:]]))
        h_rows = h_block[0].index_select(0, nodes_w)         # [g + 1, D]
        # the staged block read from t = pos - 1, the path written from
        # t + 1, both starts clamped as XLA's dynamic slices clamp them
        L, M = st.pos - 1, st.slack
        keep = (torch.arange(g, device=tok.device) < n)[:, None]
        stage = L.clamp(max=M - N) + torch.arange(N, device=tok.device)
        commit = (L + 1).clamp(max=M - g) + torch.arange(g, device=tok.device)
        for kv in (st.cache["k"], st.cache["v"]):
            for c in kv:
                staged = c[0].index_select(1, stage)          # [Hkv, N, Dh]
                sel = staged.index_select(1, chain_b)         # [Hkv, g, Dh]
                c[0].index_copy_(1, commit, torch.where(keep, sel, 0.0))
        return path, n, bonus, h_rows

    def _iteration(self, i: int) -> None:
        """One verify iteration over the state (JAX's ``body`` of the
        proposer's generator), masked off when the request no longer
        runs."""
        st = self
        active = (st.pos < st.max_len) & ~st.done            # [1]
        # the caches hold the confirmed prefix: their length follows pos,
        # which an iteration past the end leaves as it was
        st.cache["length"].copy_(st.pos - 1)
        if st.draft_cache is not None:
            st.draft_cache["length"].copy_(st.pos - 1)
        d, n, t_new, h_rows = getattr(st, "_" + st.propose)(i)
        # the window written: d_1..d_n, t_new, pad...; cut after an EOS
        g, idx = st.gamma, st._idx
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
        if h_rows is not None:
            # the hidden state whose base head predicted the new last token:
            # its heads cover the gamma slots after it
            st.h_last.copy_(torch.where(active, h_rows.index_select(0, at)[0],
                                        st.h_last))
        st.pos.add_(torch.where(active, limit, 0))
        st.n_steps.add_(active.long())


def spec_state(params: dict, cfg: GPTConfig, propose: str, max_len: int,
               gamma: int, k_verifies: int, top_k: int, greedy: bool,
               top_p, min_p, eos_id: int, pad_id: int, device, heads=None,
               ngram: int = 3, eager: bool = False, draft: tuple | None = None,
               tree: tuple | None = None, tp=None) -> tuple:
    """-> (the graph key of a :class:`SpecLoop`, a function that makes
    one): what JAX's ``static_argnames`` key its jits by (cfg, max_len and
    the cache's slack, k_verifies, gamma, ngram, top_k, greedy, whether
    top-p and min-p are on, the draft's config, the tree), never a value a
    request fills in; and the model groups of the target and the draft,
    so that a sharded loop and an unsharded one never share a graph."""
    top_p_on = top_p is not None and float(top_p) < 1.0
    min_p_on = min_p is not None and float(min_p) > 0.0
    args = (cfg, propose, int(max_len), int(gamma), int(k_verifies),
            int(top_k), bool(greedy), top_p_on, min_p_on, int(eos_id),
            int(pad_id), torch.device(device))
    key = ("spec", id(params), id(heads), *args, int(ngram), bool(eager),
           None if draft is None else (id(draft[0]), draft[1],
                                       id(draft[2])), tree, id(tp))
    return key, lambda: SpecLoop(params, *args, heads=heads, ngram=ngram,
                                 eager=eager, draft=draft, tree=tree, tp=tp)


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
                           min_p: float = 0.0, eager: bool = False,
                           tp=None):
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
    instead of replaying graphs, to compare the two. ``tp``: the model
    group, ``params`` this rank's blocks (:class:`SpecLoop`)."""
    assert ngram >= 1 and gamma >= 1
    assert prompt.shape[0] == 1, \
        "prompt-lookup decoding is a batch-1 latency optimization"
    key, make = spec_state(params, cfg, "lookup", max_len, gamma, K_VERIFIES,
                           top_k, greedy, top_p, min_p, eos_id, pad_id,
                           prompt.device, ngram=ngram, eager=eager, tp=tp)
    with graphs.pooled(key, make) as st:
        return run_to_end(st, prompt, prompt_len, rng, temperature, top_p,
                          min_p)



@torch.no_grad()
def generate_speculative(params_t: dict, params_d: dict, prompt: torch.Tensor,
                         prompt_len: int, rng, cfg_t: GPTConfig,
                         cfg_d: GPTConfig, max_len: int, gamma: int = 4,
                         temperature: float = 1.0, top_k: int = 50,
                         eos_id: int = -1, pad_id: int = 0,
                         greedy: bool = False, top_p: float = 1.0,
                         min_p: float = 0.0, eager: bool = False,
                         tp=None, tp_d=None):
    """Draft-model speculative decoding: the draft proposes ``gamma``
    tokens with its own sampled steps, the target verifies them in one
    block forward, proposals are accepted with probability min(1, p/q),
    the first rejection resamples from normalize(max(p - q, 0)), and a
    fully accepted block earns a bonus token. The output distribution is
    the target's; greedy output equals the target's plain greedy decode.
    Both models must be corrected causal ones with ``n_pos >= max_len +
    gamma``; batch 1.

    prompt [1, P] (a bucket, on the params' device), ``rng`` a
    ``prng.PRNGKey`` -> (tokens [1, max_len] int64 on the host, n_tokens),
    JAX's result. ``eager=True`` issues every iteration from the host
    instead of replaying graphs, to compare the two. ``tp``: the target's
    model group, ``params_t`` this rank's blocks; ``tp_d``: the draft's,
    the same group or None (the draft whole on every rank)
    (:class:`SpecLoop`)."""
    assert cfg_t.causal and cfg_d.causal, "speculative requires causal"
    assert not (cfg_t.pos_broadcast_bug or cfg_d.pos_broadcast_bug)
    assert prompt.shape[0] == 1, \
        "speculative decoding is a batch-1 latency optimization"
    assert cfg_t.n_pos >= max_len + gamma, \
        "target pos table too small for the speculative block overshoot"
    assert cfg_d.n_pos >= max_len + gamma
    key, make = spec_state(params_t, cfg_t, "draft", max_len, gamma,
                           K_VERIFIES, top_k, greedy, top_p, min_p, eos_id,
                           pad_id, prompt.device, eager=eager,
                           draft=(params_d, cfg_d, tp_d), tp=tp)
    with graphs.pooled(key, make) as st:
        buf, pos, _ = run_to_end(st, prompt, prompt_len, rng, temperature,
                                 top_p, min_p)
    return buf, pos
