"""Structured logging, latency statistics and the port's spans.

The reference's observability was print() statements in the request path
(api_cache.py:188-206) and tqdm postfixes (SURVEY.md §5.5). Here:
JSON-line structured events and reservoir-based p50/p95 latency tracking
(the BASELINE metrics), copied from the JAX package, and one span
mechanism on ``torch.profiler``:

- :func:`span` times a stretch of the program's host work. It records
  only while a ``torch.profiler`` session is open in the process, read
  from ``torch.autograd.profiler._is_profiler_enabled``: a module global,
  so every thread sees it, where the profiler's own per-thread state reads
  off on a thread started before the session (the engine's worker). Off,
  a span costs that one read. A record (:class:`SpanRecord`) holds the
  name, start and end, the thread, the span enclosing it on that thread,
  the request it serves and its counts, stamped on the clock of the
  profiler's host records (the Unix clock, ``time.time_ns``), so a reader
  lays spans over the profiler's device activities with no offset to fit.
  On a thread the session traces, the span is also a ``record_function``
  range in the profiler's own records.
- :func:`add_span` records a span that starts on one thread and ends on
  another (a request's wait for the engine), from stamps of
  :func:`clock_ns`.
- :func:`spans` returns the last session's records; :func:`profiler_trace`
  (``/profile``) writes them into its Chrome trace.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import NamedTuple

from torch.autograd import profiler as _profiler

# records kept of one session; the oldest go first
SPAN_CAPACITY = 1 << 18

# the clock of the profiler's host records
clock_ns = time.time_ns


class JsonLogger:
    """One JSON object per line; thread-safe."""

    def __init__(self, stream=None, component: str = "eamg"):
        self.stream = stream or sys.stderr
        self.component = component
        self._lock = threading.Lock()

    def log(self, event: str, **fields) -> None:
        rec = {"ts": round(time.time(), 3), "component": self.component,
               "event": event, **fields}
        with self._lock:
            self.stream.write(json.dumps(rec) + "\n")
            self.stream.flush()


class LatencyStats:
    """Rolling-window latency percentiles + counters; thread-safe."""

    def __init__(self, window: int = 1024):
        self.window = window
        self._samples: list[float] = []
        self._count = 0
        self._tokens = 0
        self._lock = threading.Lock()

    def observe(self, seconds: float, tokens: int = 0) -> None:
        with self._lock:
            self._count += 1
            self._tokens += tokens
            self._samples.append(seconds)
            if len(self._samples) > self.window:
                self._samples = self._samples[-self.window:]

    def percentile(self, q: float) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            s = sorted(self._samples)
            idx = min(int(q / 100.0 * len(s)), len(s) - 1)
            return s[idx]

    def summary(self) -> dict:
        with self._lock:
            n, toks = self._count, self._tokens
        return {
            "count": n,
            "tokens": toks,
            "p50_ms": round(self.percentile(50) * 1000, 2),
            "p95_ms": round(self.percentile(95) * 1000, 2),
            "p99_ms": round(self.percentile(99) * 1000, 2),
        }


class SpanRecord(NamedTuple):
    """One span: its name, start and end (ns, :func:`clock_ns`), the OS id
    of its thread, the name of the span open around it on that thread
    (None at the top, and for :func:`add_span`'s), the request it served
    (``rid``) and its counts."""
    name: str
    start_ns: int
    end_ns: int
    tid: int
    parent: str | None
    rid: int | None
    counts: dict


class _Spans:
    """The process's bounded buffer of records and each thread's stack of
    open span names. A session's first record clears what an earlier
    session left once :func:`spans` has read it; a span is recorded only
    if it ends while the session is open."""

    def __init__(self, capacity: int):
        self.records: deque = deque(maxlen=capacity)
        self.lock = threading.Lock()
        self.local = threading.local()
        self.read = False

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def add(self, rec: SpanRecord) -> None:
        with self.lock:
            if self.read:
                self.records.clear()
                self.read = False
            self.records.append(rec)

    def take(self) -> list:
        with self.lock:
            if not _profiler._is_profiler_enabled:
                self.read = True
            return list(self.records)


_SPANS = _Spans(SPAN_CAPACITY)


class _Null:
    """The span of a process with no session open: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts) -> None:
        pass


_NULL = _Null()


class _Span:
    __slots__ = ("name", "rid", "ms", "counts", "t0", "start", "parent",
                 "stack", "rf")

    def __init__(self, name: str, rid, ms, counts: dict):
        self.name, self.rid, self.ms, self.counts = name, rid, ms, counts
        self.start = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            # the stack of the thread that opened it (a generator's span
            # may close on another)
            self.stack = stack = _SPANS.stack()
            self.parent = stack[-1] if stack else None
            stack.append(self.name)
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
            self.start = clock_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def count(self, **counts) -> None:
        """Add counts known only at the span's end."""
        self.counts.update(counts)

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.ms is not None:
            key = self.name.rpartition(".")[2]
            self.ms[key] = self.ms.get(key, 0.0) + dt / 1e6
        if self.start is not None:
            self.rf.__exit__(None, None, None)
            self.stack.pop()
            if _profiler._is_profiler_enabled:
                _SPANS.add(SpanRecord(self.name, self.start,
                                      self.start + dt,
                                      threading.get_native_id(), self.parent,
                                      self.rid, self.counts))
        return False


def span(name: str, rid: int | None = None, ms: dict | None = None,
         **counts):
    """A context manager over a stretch of host work named ``name``
    (``layer.part``), serving request ``rid``, with ``counts`` (more at its
    end through ``.count(...)``). Recorded while a profiler session is
    open (the module's docstring); with ``ms`` it also adds its duration in
    ms to ``ms[<name's last part>]`` always."""
    if ms is None and not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, rid, ms, counts)


def add_span(name: str, start_ns: int, end_ns: int | None = None,
             rid: int | None = None, tid: int | None = None,
             **counts) -> None:
    """Record a span from ``start_ns`` to ``end_ns`` (now when None), both
    from :func:`clock_ns`, on thread ``tid`` (this one when None), if a
    session is open."""
    if _profiler._is_profiler_enabled:
        _SPANS.add(SpanRecord(
            name, start_ns, clock_ns() if end_ns is None else end_ns,
            threading.get_native_id() if tid is None else tid, None, rid,
            counts))


def spans() -> list:
    """The records of the last profiler session (of the open one while it
    is open), oldest first."""
    return _SPANS.take()


def _append_spans(path: str, records: list) -> None:
    """Add ``records`` to the Chrome trace at ``path`` as complete events
    on their threads' ids, in µs from the trace's base time."""
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "span", "name": r.name, "pid": pid,
         "tid": r.tid, "ts": (r.start_ns - base) / 1e3,
         "dur": (r.end_ns - r.start_ns) / 1e3,
         "args": {"parent": r.parent, "rid": r.rid, **r.counts}}
        for r in records)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)


@contextmanager
def profiler_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (the host's
    operators and, on a CUDA host, the card's kernels) and write it into
    ``log_dir`` as a Chrome trace (``trace.json``: chrome://tracing or
    Perfetto), with the spans of every thread (the engine's worker too)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _append_spans(path, spans())
