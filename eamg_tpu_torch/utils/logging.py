"""Structured logging + latency statistics.

The reference's observability was print() statements in the request path
(api_cache.py:188-206) and tqdm postfixes (SURVEY.md §5.5). Here:
JSON-line structured events, reservoir-based p50/p95 latency tracking
(the BASELINE metrics). Copied from the JAX package, with its profiler
hook on ``torch.profiler``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager


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


@contextmanager
def timed(stats: LatencyStats | None = None, logger: JsonLogger | None = None,
          event: str = "timed", **fields):
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        dt = time.perf_counter() - t0
        if stats is not None:
            stats.observe(dt, tokens=holder.get("tokens", 0))
        if logger is not None:
            logger.log(event, duration_ms=round(dt * 1000, 2), **fields)


@contextmanager
def profiler_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (the host's
    operators and, on a CUDA host, the card's kernels) and write it into
    ``log_dir`` as a Chrome trace (``trace.json``: chrome://tracing or
    Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
