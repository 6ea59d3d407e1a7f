"""Request coalescing by window: concurrent /generate calls share one
ragged decode.

Port of ``eamg_tpu/serve/batcher.py``. Requests that arrive within a small
window are grouped by their sampling params, padded into a ragged batch
(``decode/ragged.py``) and decoded together; each row carries its own
PRNG key, so a coalesced request returns the stream it would have produced
alone. Batch sizes bucket to {1, 2, 4, 8, ...} with dummy rows. On
tensor-parallel params of a model group of one (``Generator(tp=)``) the
ragged decode runs on the rank's blocks; a larger group is refused. Groups
are keyed by every option the ragged decode takes batch-wide: the
sampling values, the budget's bucket, the penalties, the n-gram size and
grammar on or off (with the batcher's grammar, when it was given one).
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
from .continuous import _NEUTRAL_PEN, EngineOverloaded, wait_for_worker


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
        tp = generator.tp
        if tp is not None and tp.size > 1:
            raise ValueError(
                "the window batcher on a model group of more than one rank: "
                "its groups have no plan for the followers yet; serve the "
                "group through ContinuousBatcher")
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
        self._thread = threading.Thread(target=self._worker, daemon=True)
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
        when the batcher has one."""
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
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout)

    # ------------------------------------------------------------- worker

    def _worker(self):
        bind_thread_to(self.device)
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
            for params, reqs in by_params.items():
                try:
                    self._run(reqs, *params)
                except Exception as exc:  # noqa: BLE001 - worker survives
                    for r in reqs:
                        r.error = exc
                        r.event.set()
            self._busy = False

    def _run(self, reqs, temperature, top_k, top_p, min_p, greedy, max_len,
             penalties=_NEUTRAL_PEN, no_repeat_ngram=0, grammar=False):
        n = len(reqs)
        bs = 1
        while bs < n:
            bs *= 2
        width = min(_bucket(max(len(r.prompt_ids) for r in reqs)), max_len)
        prompt = np.full((bs, width), self.gen.pad_id, np.int64)
        lens = np.ones((bs,), np.int32)  # dummy rows: 1-token prompts
        seeds = [0] * bs
        for i, r in enumerate(reqs):
            # leave at least one generation slot: a prompt that fills the
            # request's whole budget would otherwise produce nothing
            p = r.prompt_ids[:min(width, max(1, r.max_len - 1))]
            prompt[i, :len(p)] = p
            lens[i] = len(p)
            seeds[i] = r.seed
        buf, pos = generate_kv_ragged(
            self.gen.params, torch.from_numpy(prompt).to(self.device), lens,
            prng.key_rows(seeds), self.gen.cfg, max_len,
            temperature=temperature, top_k=top_k, eos_id=self.gen.eos_id,
            pad_id=self.gen.pad_id, greedy=greedy, top_p=top_p, min_p=min_p,
            penalties=penalties, no_repeat_ngram=no_repeat_ngram,
            grammar=self.grammar if grammar else None, eager=self.eager,
            tp=self.gen.tp)
        buf = buf.cpu().numpy()
        pos = pos.cpu().numpy()
        self.stats["calls"] += 1
        self.stats["requests"] += n
        self.stats["max_group"] = max(self.stats["max_group"], n)
        for i, r in enumerate(reqs):
            r.result = buf[i, :min(int(pos[i]), r.max_len)].tolist()
            r.event.set()
