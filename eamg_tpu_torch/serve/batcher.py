"""Request coalescing by window: concurrent /generate calls share one
ragged decode.

Port of ``eamg_tpu/serve/batcher.py``. Requests that arrive within a small
window are grouped by their sampling params, padded into a ragged batch
(``decode/ragged.py``) and decoded together; each row carries its own
PRNG key, so a coalesced request returns the stream it would have produced
alone. Batch sizes bucket to {1, 2, 4, 8, ...} with dummy rows. Groups
are keyed by every option the ragged decode takes batch-wide: the
sampling values, the budget's bucket, the penalties, the n-gram size and
grammar on or off (with the batcher's grammar, when it was given one).

On tensor-parallel params (``Generator(tp=)``, one process a rank, each
holding its blocks) the ragged decode runs on every rank of the model
group with the rank's blocks, the same call in the same order. Rank 0
leads: it owns the queue, ``submit``, the window, ``drain`` and
``close``, and before each group it decodes it broadcasts that group as
a plan through the engine's channel (``continuous._PlanChannel``): a
record a row (its prompt, key, budget, temperature and sampling values)
and the group's batch-wide options. The other ranks build the same
batcher and call :meth:`RequestBatcher.serve_follower`, which decodes
each plan as it comes and returns at "stop". Faults are met as the
engine meets them (``serve/continuous.py``): one in the leader's own work
sends the followers "stop", one that a plan brings raises on every rank,
and a follower's own fault ends its process. On a group of more than one
rank the decode issues its steps from the host; a group of one keeps its
graphs.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..decode.api import Generator, _bucket
from ..decode.ragged import generate_kv_ragged
from ..utils import prng
from ..utils.device import bind_thread_to
from .continuous import (_NEUTRAL_PEN, EngineOverloaded, _Admission,
                         _PlanChannel, wait_for_worker)


@dataclass
class _Pending:
    prompt_ids: list
    temperature: float
    top_k: int
    top_p: float
    min_p: float
    greedy: bool
    seed: int
    max_len: int
    penalties: tuple = _NEUTRAL_PEN
    ngram: int = 0
    grammar: bool = False
    event: threading.Event = field(default_factory=threading.Event)
    result: list | None = None
    error: Exception | None = None


class RequestBatcher:
    def __init__(self, generator: Generator, max_batch: int = 8,
                 window_ms: float = 10.0, max_len: int | None = None,
                 max_queue: int = 256, grammar=None, eager: bool = False):
        self.gen = generator
        # the served scheme's FSM (decode.grammar.Grammar) for the requests
        # that ask grammar=true; None turns them away (solo decode)
        self.grammar = grammar
        # the ragged decode replays CUDA graphs on the card; eager=True
        # issues its steps from the host, to compare the two (no served
        # path passes it)
        self.eager = bool(eager)
        # where the parameters really are (with its index), for the worker
        self.device = generator.params["tok_emb"].device
        self.max_batch = max_batch
        self.window = window_ms / 1000.0
        self.max_len = min(max_len or generator.cfg.seq_len,
                           generator.max_supported_len())
        self.max_queue = max_queue       # 0 = unbounded
        self._q: queue.Queue = queue.Queue()
        self.stats = {"calls": 0, "requests": 0, "max_group": 0,
                      "rejected": 0}
        self._stop = False
        self._busy = False   # worker holds a dequeued group (drain())
        # a model group of more than one rank: rank 0 leads, the others
        # decode its plans (the module's docstring); a plan's words are
        # the group's prompt width, top_k, greedy and n-gram size
        tp = generator.tp
        group = tp is not None and tp.size > 1
        self.leader = not group or tp.rank == 0
        self._plan = _PlanChannel(tp, 1 << (max_batch - 1).bit_length(),
                                  self.max_len, words=4) if group else None
        self._plan_open = group
        self._in_step = False   # the followers are inside a group's decode
        self._thread = threading.Thread(target=self._worker, daemon=True)
        if self.leader:
            self._thread.start()

    # ------------------------------------------------------------- client

    def overloaded(self) -> bool:
        return bool(self.max_queue) and self._q.qsize() >= self.max_queue

    def accepts(self, grammar: bool = False, medusa: bool = False,
                **_) -> bool:
        """The window batcher groups by param combination, so it takes any
        sampling values, penalties and n-gram size; a grammar request needs
        the batcher's grammar, and a medusa request the solo decode.
        Callers fall back to a solo decode otherwise."""
        return (not grammar or self.grammar is not None) and not medusa

    def submit(self, prompt_ids: list[int], temperature: float = 1.0,
               top_k: int = 50, greedy: bool = False,
               seed: int | None = None, timeout: float = 600.0,
               max_len: int | None = None, top_p: float = 1.0,
               min_p: float = 0.0, penalties: tuple | None = None,
               no_repeat_ngram: int = 0, grammar: bool = False) -> list:
        if not self.leader:
            raise RuntimeError(
                f"rank {self.gen.tp.rank} of the model group follows rank "
                "0's plans (serve_follower); send requests to rank 0")
        if grammar and self.grammar is None:
            raise ValueError(
                "batcher was built without a grammar table; construct "
                "RequestBatcher(grammar=...) for constrained requests")
        ml = int(min(max_len or self.max_len, self.max_len))
        if len(prompt_ids) >= ml:
            # zero generation steps: prompt returned unchanged (reference
            # semantics), as generate_ids and ContinuousBatcher.submit do
            return list(prompt_ids)
        req = _Pending(prompt_ids, float(temperature), int(top_k),
                       float(top_p), float(min_p), bool(greedy),
                       int(seed) if seed is not None
                       else int(time.time_ns() % 2**31), ml,
                       tuple(float(v) for v in penalties)
                       if penalties is not None else _NEUTRAL_PEN,
                       int(no_repeat_ngram or 0), bool(grammar))
        if self.overloaded():
            self.stats["rejected"] += 1
            raise EngineOverloaded(
                f"batcher admission queue full "
                f"({self.max_queue} requests waiting)")
        self._q.put(req)
        if not wait_for_worker(req.event, self._thread, timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def warmup(self, prompt_ids: list[int], penalties: tuple | None = None,
                no_repeat_ngram: int = 0) -> None:
        """Capture the graphs of the ragged decode that served requests
        replay: one generation of ``prompt_ids`` for each batch the worker
        pads a group to (1, 2, 4, ... up to ``max_batch``) at the budget
        of a request that names none, with the default sampling (and
        ``penalties`` and ``no_repeat_ngram``), and with the grammar on too
        when the batcher has one. A model group of more than one rank
        captures none (its steps are issued from the host)."""
        if self._plan is not None:
            return
        for grammar in (None, self.grammar) if self.grammar is not None \
                else (None,):
            bs = 1
            while True:
                prompt = np.full((bs, _bucket(len(prompt_ids))),
                                 self.gen.pad_id, np.int64)
                prompt[:, :len(prompt_ids)] = prompt_ids
                generate_kv_ragged(
                    self.gen.params, torch.from_numpy(prompt).to(self.device),
                    [len(prompt_ids)] * bs, prng.key_rows(range(bs)),
                    self.gen.cfg, self.max_len, eos_id=self.gen.eos_id,
                    pad_id=self.gen.pad_id, penalties=penalties,
                    no_repeat_ngram=no_repeat_ngram, grammar=grammar,
                    eager=self.eager, tp=self.gen.tp)
                if bs >= self.max_batch:
                    break
                bs *= 2

    def drain(self, timeout: float = 30.0) -> bool:
        """Wait for queued and in-flight groups to finish (graceful
        shutdown; the same three-consecutive-idle-polls rule as
        ContinuousBatcher.drain)."""
        deadline = time.monotonic() + timeout
        idle = 0
        while time.monotonic() < deadline:
            if self._q.qsize() == 0 and not self._busy:
                idle += 1
                if idle >= 3:
                    return True
            else:
                idle = 0
            time.sleep(0.05)
        return self._q.qsize() == 0 and not self._busy

    def close(self, timeout: float = 30.0):
        """Stop the worker (the leader's: its followers' loops return)."""
        self._stop = True
        self._q.put(None)
        if self._thread.is_alive():
            self._thread.join(timeout)

    def serve_follower(self) -> None:
        """A follower rank's loop (ranks 1.. of a model group): decode
        each group rank 0 broadcasts, until "stop". Blocks; raises what a
        decode raises, and the caller's process is then to exit, so that
        the leader's pending collective raises at once."""
        if self.leader:
            raise RuntimeError("serve_follower runs on ranks 1.. of a "
                               "model group; rank 0 serves requests")
        bind_thread_to(self.device)
        while True:
            plan = self._plan.recv()
            if plan is None:
                return
            self._decode(*plan)

    # ------------------------------------------------------------- worker

    def _worker(self):
        bind_thread_to(self.device)
        try:
            self._work()
        finally:
            if self._plan_open:
                # the followers wait for a plan: they return
                self._plan_open = False
                self._plan.stop()

    def _work(self):
        while not self._stop:
            first = self._q.get()
            self._busy = True     # before any check: drain() must see it
            if first is None:
                break
            group = [first]
            deadline = time.monotonic() + self.window
            while len(group) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:          # close() sentinel mid-window
                    self._stop = True
                    break
                group.append(nxt)
            # split by sampling params (one ragged call per combination);
            # max_len buckets to powers of two as in the JAX package
            by_params: dict = {}
            for r in group:
                ml = min(1 << (r.max_len - 1).bit_length(), self.max_len)
                by_params.setdefault(
                    (r.temperature, r.top_k, r.top_p, r.min_p, r.greedy, ml,
                     r.penalties, r.ngram, r.grammar), []).append(r)
            groups = list(by_params.items())
            for gi, (params, reqs) in enumerate(groups):
                try:
                    self._run(reqs, *params)
                except Exception as exc:  # noqa: BLE001 - worker survives
                    for r in reqs:
                        r.error = exc
                        r.event.set()
                    if self._plan is not None:
                        # followers inside the decode cannot take a
                        # "stop"; the others get it. The batcher closes
                        if self._in_step:
                            self._plan_open = False
                        self._fail_rest(exc, groups[gi + 1:])
                        return
            self._busy = False

    def _fail_rest(self, exc: Exception, groups: list) -> None:
        """Deliver ``exc`` to the requests of ``groups`` and to every
        queued one (a model group's leader on its way out)."""
        self._stop, self._busy = True, False
        rest = [r for _, reqs in groups for r in reqs]
        while True:
            try:
                r = self._q.get(block=False)
            except queue.Empty:
                break
            if r is not None:
                rest.append(r)
        for r in rest:
            r.error = exc
            r.event.set()

    def _run(self, reqs, temperature, top_k, top_p, min_p, greedy, max_len,
             penalties=_NEUTRAL_PEN, no_repeat_ngram=0, grammar=False):
        n = len(reqs)
        bs = 1
        while bs < n:
            bs *= 2
        width = min(_bucket(max(len(r.prompt_ids) for r in reqs)), max_len)
        # dummy rows: 1-token prompts of pad_id, seed 0
        keys = prng.key_rows([r.seed for r in reqs] + [0] * (bs - n))
        rows = []
        for i in range(bs):
            # leave at least one generation slot: a prompt that fills the
            # request's whole budget would otherwise produce nothing
            p = reqs[i].prompt_ids[:min(width, max(1, reqs[i].max_len - 1))] \
                if i < n else [self.gen.pad_id]
            rows.append(_Admission(i, tuple(p), tuple(keys[i]), max_len,
                                   temperature, top_p, min_p, penalties,
                                   bool(no_repeat_ngram), grammar))
        words = (width, top_k, greedy, no_repeat_ngram)
        if self._plan is not None:
            self._plan.send(rows, words)
            self._in_step = True
        buf, pos = self._decode(rows, words)
        self._in_step = False
        self.stats["calls"] += 1
        self.stats["requests"] += n
        self.stats["max_group"] = max(self.stats["max_group"], n)
        for i, r in enumerate(reqs):
            r.result = buf[i, :min(int(pos[i]), r.max_len)].tolist()
            r.event.set()

    def _decode(self, rows: list, words: tuple) -> tuple:
        """The ragged decode of one group, every rank of a model group
        alike: ``rows`` its rows' records (``continuous._Admission``),
        ``words`` the prompt width, top_k, greedy and the n-gram size ->
        (buf, pos) on the host."""
        width, top_k, greedy, ngram = words
        r0 = rows[0]
        prompt = np.full((len(rows), width), self.gen.pad_id, np.int64)
        for i, r in enumerate(rows):
            prompt[i, :len(r.prompt_ids)] = r.prompt_ids
        buf, pos = generate_kv_ragged(
            self.gen.params, torch.from_numpy(prompt).to(self.device),
            [len(r.prompt_ids) for r in rows],
            np.asarray([r.key for r in rows], np.uint32), self.gen.cfg,
            r0.rmax, temperature=r0.temp, top_k=top_k,
            eos_id=self.gen.eos_id, pad_id=self.gen.pad_id,
            greedy=bool(greedy), top_p=r0.top_p, min_p=r0.min_p,
            penalties=r0.penalties, no_repeat_ngram=ngram,
            grammar=self.grammar if r0.gram_on else None, eager=self.eager,
            tp=self.gen.tp)
        return buf.cpu().numpy(), pos.cpu().numpy()
