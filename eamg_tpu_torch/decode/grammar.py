"""Grammar-constrained decoding: an FSM over the music token grammar.

Port of ``eamg_tpu/decode/grammar.py``. Every token scheme has a rigid
surface grammar: Scheme B2 streams are ``[START_SEQ] ([NOTE] P_x T_y
DUR_z)* [END_SEQ]``, B3 puts optional ``BPM_x KEY_y`` controls right after
START, and Scheme A's detokenizer drops notes written before any
``[INSTRUMENT]``. The decode loops enforce it on the device as a
deterministic finite automaton:

- ``tclass``    [V]    token id -> grammar class (PITCH, TIME, NOTE, ...)
- ``allowed``   [S, C] which classes each state admits
- ``next``      [S, C] the state after emitting a class
- ``need_next`` [S, C] / ``steps`` [S] / ``closing`` [S, C]: the
  budget rule, a class is admitted only while the shortest completion
  after emitting it (``1 + need_next``) still fits the tokens left, so a
  stream never enters a note it cannot finish and closes with its END
  token in budget.

The host tables (:class:`Grammar`, the per-scheme builders,
:meth:`Grammar.violations`) are numpy, as in the JAX package. On the
device, :func:`grammar_mask` replaces the logits of disallowed tokens with
:data:`GRAMMAR_MASK`; JAX takes the allowed tokens as a [B, C] x [C, V]
product with the classes' one-hot rows, here a gather of the allowed
classes by ``tclass`` gives the same booleans with one kernel inside a
captured step. :func:`grammar_step` advances the states by the sampled
tokens, and :func:`scan_prompt_state` recovers the state after a prompt by
composing the prompt tokens' transition maps pairwise, ``log2(P)`` levels
deep (JAX's ``associative_scan``), which gives the same integers as a
left-to-right walk.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

# Replacement (not additive) mask: the grammar dominates every other logit
# transform (the n-gram ban adds -1e10; a token the grammar forces must win
# even when it is also banned).
GRAMMAR_MASK = -1e30


@dataclass(frozen=True)
class Grammar:
    """Host-side FSM tables. Build with :func:`grammar_for` (or the
    per-scheme builders); :meth:`arrays` makes their device tensors."""

    tclass: np.ndarray        # [V] int32: token id -> class index
    allowed: np.ndarray       # [S, C] bool
    next_state: np.ndarray    # [S, C] int32 (total: disallowed -> stay)
    closing: np.ndarray       # [S, C] bool: the shortest path to DONE
    steps_to_close: np.ndarray  # [S] int32: tokens needed to reach DONE
    init_state: int
    classes: tuple[str, ...]
    states: tuple[str, ...]
    # device tensors by device, made once: a CUDA graph captures them by
    # address, so every call must hand it the same ones
    _on: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def n_states(self) -> int:
        return len(self.states)

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    def arrays(self, device=None) -> dict:
        """The tables on ``device`` (made at the first call, the same
        tensors at every later one): ``tclass`` [V], ``allowed`` and
        ``closing`` [S, C] bool, ``need_next`` [S, C] (the tokens needed to
        reach DONE after emitting class c from state s: the budget check
        looks ahead one token), ``steps`` [S], ``next`` [S, C] and ``init``
        [1], integers as int64 (torch's index type)."""
        dev = torch.device("cpu" if device is None else device)
        key = str(dev)
        if key not in self._on:
            need_next = self.steps_to_close[self.next_state]

            def ints(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=dev)

            self._on[key] = {
                "tclass": ints(self.tclass),
                "allowed": torch.as_tensor(self.allowed, device=dev),
                "closing": torch.as_tensor(self.closing, device=dev),
                "need_next": ints(need_next),
                "steps": ints(self.steps_to_close),
                "next": ints(self.next_state),
                "init": ints([self.init_state]),
            }
        return self._on[key]

    def violations(self, ids) -> int:
        """Count invalid transitions in a token-id stream (host numpy)."""
        s = self.init_state
        bad = 0
        for i in ids:
            c = int(self.tclass[int(i)])
            if not self.allowed[s, c]:
                bad += 1
            s = int(self.next_state[s, c])
        return bad


def _build(classes: list[str], states: list[str], rules: dict,
           closing_rules: dict, tclass: np.ndarray, init: str) -> Grammar:
    """rules / closing_rules: state -> {class: next_state}. ``next`` is made
    total by keeping disallowed transitions in place (prompt scans recover
    from malformed prompts)."""
    S, C = len(states), len(classes)
    sidx = {s: i for i, s in enumerate(states)}
    cidx = {c: i for i, c in enumerate(classes)}
    allowed = np.zeros((S, C), bool)
    closing = np.zeros((S, C), bool)
    nxt = np.tile(np.arange(S, dtype=np.int32)[:, None], (1, C))
    for st, edges in rules.items():
        for cl, to in edges.items():
            allowed[sidx[st], cidx[cl]] = True
            nxt[sidx[st], cidx[cl]] = sidx[to]
    for st, edges in closing_rules.items():
        for cl in edges:
            closing[sidx[st], cidx[cl]] = True
    # steps_to_close[s] = BFS distance to DONE along closing edges
    steps = np.full((S,), 10 ** 6, np.int64)
    steps[sidx["DONE"]] = 0
    for _ in range(S):
        for st, edges in closing_rules.items():
            for cl in edges:
                to = nxt[sidx[st], cidx[cl]]
                steps[sidx[st]] = min(steps[sidx[st]], steps[to] + 1)
    assert steps.max() < 10 ** 6, "closing path must reach DONE everywhere"
    return Grammar(tclass=tclass, allowed=allowed, next_state=nxt,
                   closing=closing, steps_to_close=steps.astype(np.int32),
                   init_state=sidx[init], classes=tuple(classes),
                   states=tuple(states))


def _classify(id2tok: dict, n: int, prefixes: list[tuple[str, str]],
              other: str, classes: list[str]) -> np.ndarray:
    cidx = {c: i for i, c in enumerate(classes)}
    out = np.full((n,), cidx[other], np.int32)
    for i in range(n):
        tok = id2tok.get(i, "")
        for pre, cl in prefixes:
            if tok == pre or tok.startswith(pre + " ") or (
                    pre.endswith("_") and tok.startswith(pre)):
                out[i] = cidx[cl]
                break
    return out


def grammar_b2(scheme) -> Grammar:
    """SchemeB2: [START_SEQ] ([NOTE] P T DUR)* [END_SEQ], then PAD."""
    classes = ["OTHER", "PAD", "START", "END", "NOTE", "PITCH", "TIME",
               "DUR"]
    tclass = _classify(
        scheme.vocab.id2tok, len(scheme.vocab),
        [("[PAD]", "PAD"), ("[START_SEQ]", "START"), ("[END_SEQ]", "END"),
         ("[NOTE]", "NOTE"), ("P_", "PITCH"), ("T_", "TIME"),
         ("DUR_", "DUR")], "OTHER", classes)
    states = ["INIT", "EVENT", "P", "T", "D", "DONE"]
    rules = {
        "INIT": {"START": "EVENT"},
        "EVENT": {"NOTE": "P", "END": "DONE"},
        "P": {"PITCH": "T"},
        "T": {"TIME": "D"},
        "D": {"DUR": "EVENT"},
        "DONE": {"PAD": "DONE"},
    }
    closing = {
        "INIT": {"START"}, "EVENT": {"END"}, "P": {"PITCH"},
        "T": {"TIME"}, "D": {"DUR"}, "DONE": {"PAD"},
    }
    return _build(classes, states, rules, closing, tclass, "INIT")


def grammar_b3(scheme) -> Grammar:
    """SchemeB3: B2 and the optional BPM then KEY controls right after
    START (BPM before KEY)."""
    classes = ["OTHER", "PAD", "START", "END", "NOTE", "PITCH", "TIME",
               "DUR", "BPM", "KEY"]
    tclass = _classify(
        scheme.vocab.id2tok, len(scheme.vocab),
        [("[PAD]", "PAD"), ("[START_SEQ]", "START"), ("[END_SEQ]", "END"),
         ("[NOTE]", "NOTE"), ("P_", "PITCH"), ("T_", "TIME"),
         ("DUR_", "DUR"), ("BPM_", "BPM"), ("KEY_", "KEY")],
        "OTHER", classes)
    states = ["INIT", "CTRL", "CTRL_K", "EVENT", "P", "T", "D", "DONE"]
    rules = {
        "INIT": {"START": "CTRL"},
        # after START: optional BPM, then optional KEY, then events
        "CTRL": {"BPM": "CTRL_K", "KEY": "EVENT", "NOTE": "P",
                 "END": "DONE"},
        "CTRL_K": {"KEY": "EVENT", "NOTE": "P", "END": "DONE"},
        "EVENT": {"NOTE": "P", "END": "DONE"},
        "P": {"PITCH": "T"},
        "T": {"TIME": "D"},
        "D": {"DUR": "EVENT"},
        "DONE": {"PAD": "DONE"},
    }
    closing = {
        "INIT": {"START"}, "CTRL": {"END"}, "CTRL_K": {"END"},
        "EVENT": {"END"}, "P": {"PITCH"}, "T": {"TIME"}, "D": {"DUR"},
        "DONE": {"PAD"},
    }
    return _build(classes, states, rules, closing, tclass, "INIT")


def grammar_a(vocab) -> Grammar:
    """Scheme A (string-token vocabulary): [START_SEQUENCE], optional [BPM]
    / [KEY_SIGNATURE], then instrument sections; the detokenizer keeps a
    note only once an [INSTRUMENT] is open, so the grammar requires one."""
    classes = ["OTHER", "PAD", "START", "END", "BPM", "KEY", "INST",
               "NOTE"]
    tclass = _classify(
        vocab.id2tok, len(vocab),
        [("[PAD]", "PAD"), ("[START_SEQUENCE]", "START"),
         ("[END_SEQUENCE]", "END"), ("[BPM]", "BPM"),
         ("[KEY_SIGNATURE]", "KEY"), ("[INSTRUMENT]", "INST"),
         ("[NOTE]", "NOTE")], "OTHER", classes)
    states = ["INIT", "HDR", "HDR_K", "BODY", "SECT", "DONE"]
    rules = {
        "INIT": {"START": "HDR"},
        "HDR": {"BPM": "HDR_K", "KEY": "BODY", "INST": "SECT",
                "END": "DONE"},
        "HDR_K": {"KEY": "BODY", "INST": "SECT", "END": "DONE"},
        "BODY": {"INST": "SECT", "END": "DONE"},
        "SECT": {"NOTE": "SECT", "INST": "SECT", "END": "DONE"},
        "DONE": {"PAD": "DONE"},
    }
    closing = {
        "INIT": {"START"}, "HDR": {"END"}, "HDR_K": {"END"},
        "BODY": {"END"}, "SECT": {"END"}, "DONE": {"PAD"},
    }
    g = _build(classes, states, rules, closing, tclass, "INIT")
    # a data-dependent Scheme-A vocabulary may lack a literal [PAD]; DONE
    # must still admit something, so it falls back to looping on END
    if not (g.tclass == g.classes.index("PAD")).any():
        sidx, cidx = g.states.index("DONE"), g.classes.index("END")
        g.allowed[sidx, cidx] = True
        g.closing[sidx, cidx] = True
        g.next_state[sidx, cidx] = sidx
    return g


def grammar_for(scheme_or_vocab) -> Grammar:
    """Dispatch on the tokenizer scheme (a SchemeB2 or SchemeB3 instance)
    or a Scheme-A Vocab."""
    name = type(scheme_or_vocab).__name__
    if name == "SchemeB3":
        return grammar_b3(scheme_or_vocab)
    if name == "SchemeB2":
        return grammar_b2(scheme_or_vocab)
    if hasattr(scheme_or_vocab, "vocab"):      # other scheme objects
        return grammar_a(scheme_or_vocab.vocab)
    return grammar_a(scheme_or_vocab)


def grammar_tables(grammar, device) -> dict | None:
    """A Grammar, its :meth:`Grammar.arrays` dict, or None -> the tables
    on ``device`` (None when off)."""
    if grammar is None or isinstance(grammar, dict):
        return grammar
    return grammar.arrays(device)


# ---------------------------------------------------------------- device


def grammar_mask(logits: torch.Tensor, gstate: torch.Tensor, g: dict,
                 budget_left=None,
                 row_on: torch.Tensor | None = None) -> torch.Tensor:
    """[B, V] logits and [B] states -> the logits with every token the
    state does not admit replaced by GRAMMAR_MASK. ``budget_left`` (an int,
    or a [B] or [1] tensor) applies the budget rule: class c stays only
    while ``need_next[s, c] + 1 <= budget``; a row where nothing fits falls
    back to the shortest closing path. ``row_on`` ([B] bool) gates per
    row: a row off keeps its logits bit for bit."""
    allowed = g["allowed"][gstate]                          # [B, C]
    if budget_left is not None:
        fits = (g["need_next"][gstate] + 1) <= (
            budget_left[..., None] if isinstance(budget_left, torch.Tensor)
            else int(budget_left))
        fitted = fits & allowed
        allowed = torch.where(fitted.any(dim=-1, keepdim=True), fitted,
                              g["closing"][gstate])
    ok = allowed[:, g["tclass"]]                            # [B, V]
    if row_on is not None:
        ok = ok | ~row_on[:, None]
    return torch.where(ok, logits, GRAMMAR_MASK)


def grammar_step(gstate: torch.Tensor, token: torch.Tensor, g: dict,
                 active: torch.Tensor | None = None) -> torch.Tensor:
    """Advance [B] states by the emitted [B] tokens (inactive rows hold)."""
    nxt = g["next"][gstate, g["tclass"][token.long()]]
    if active is not None:
        nxt = torch.where(active, nxt, gstate)
    return nxt


def scan_prompt_state(g: dict, prompt: torch.Tensor, plen) -> torch.Tensor:
    """[B, P] prompt ids and per-row lengths (an int, or [B]) -> [B] states
    after the prompt. Each position is a state map [S] (a pad position the
    identity); maps are composed pairwise, the earlier first, until one is
    left, and applied to the initial state."""
    B, P = prompt.shape
    dev = prompt.device
    S = g["next"].shape[0]
    plen = torch.as_tensor(plen, device=dev).reshape(-1, 1)
    maps = g["next"][:, g["tclass"][prompt.long()]].permute(1, 2, 0)
    ident = torch.arange(S, device=dev).expand(B, 1, S)
    real = (torch.arange(P, device=dev)[None, :] < plen)[..., None]
    maps = torch.where(real, maps, ident)                   # [B, P, S]
    while maps.shape[1] > 1:
        if maps.shape[1] % 2:
            maps = torch.cat((maps, ident), dim=1)
        # out[s] = later[earlier[s]]
        maps = torch.gather(maps[:, 1::2], 2, maps[:, 0::2])
    return maps[:, 0].index_select(1, g["init"])[:, 0]
