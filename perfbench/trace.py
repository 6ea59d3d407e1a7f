"""The profiler's raw records, reduced to what the per-layer readers take.

``Trace`` runs a piece of work under ``torch.profiler`` and keeps, from the
session's raw records (read in one pass, as ``chip_smoke.py::_records``
reads them): the host's calls counted by name, the host's calls as
intervals, and the device's activities as (name, start ns, duration ns) in
the order the card started them. Busy time is the sum of the device
activities' durations on the card (graph replays included), the same
definition ``chip_smoke.py::_trace`` uses.
"""

from __future__ import annotations

import bisect
import collections
import time

# the host calls that put work on the card: kernels issued one by one, and
# graph replays
HOST_LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelEx",
                    "cudaLaunchCooperativeKernel", "cudaGraphLaunch")


class Trace:
    """Filled by :meth:`run`: ``host`` (Counter of host call names),
    ``host_spans`` [(start ns, end ns, name)], ``device`` [(name, start ns,
    duration ns)] and ``window_s`` (host clock around the traced work,
    which ends in a synchronise)."""

    def __init__(self):
        self.host = collections.Counter()
        self.host_spans: list = []
        self.device: list = []
        self.window_s = 0.0

    def run(self, work):
        """work() under the profiler -> its return value."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        if cuda:
            torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = work()
            if cuda:
                torch.cuda.synchronize()
            self.window_s = time.perf_counter() - t0
        for e in prof.profiler.kineto_results.events():
            kind = e.device_type().name
            if kind == "CPU":
                self.host[e.name()] += 1
                self.host_spans.append((e.start_ns(),
                                        e.start_ns() + e.duration_ns(),
                                        e.name()))
            elif kind == "CUDA" and not e.is_user_annotation():
                self.device.append((e.name(), e.start_ns(), e.duration_ns()))
        self.device.sort(key=lambda r: r[1])
        return out

    @property
    def busy_s(self) -> float:
        return sum(d for _, _, d in self.device) / 1e9

    def host_launches(self) -> int:
        return sum(n for k, n in self.host.items()
                   if k.startswith(HOST_LAUNCH_APIS))

    def device_seconds(self, patterns) -> tuple:
        """(seconds, count) of the device activities whose name holds one
        of ``patterns``."""
        s, n = 0, 0
        for name, _, dur in self.device:
            if any(p in name for p in patterns):
                s += dur
                n += 1
        return s / 1e9, n

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for name, _, dur in self.device:
            by[name[:120]] += dur
        return [[k, v / 1e9] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10, longest: int = 400) -> list:
        """The device's idle gaps, each named by the innermost host call
        running at its midpoint ("no host call" where none ran), summed by
        that name over the ``longest`` gaps: the ``n`` largest sums."""
        gaps, end = [], None
        for _, start, dur in self.device:
            if end is not None and start > end:
                gaps.append((start - end, end, start))
            end = start + dur if end is None else max(end, start + dur)
        gaps.sort(reverse=True)
        spans = sorted(self.host_spans)
        starts = [s for s, _, _ in spans]
        by = collections.Counter()
        for length, a, b in gaps[:longest]:
            mid = (a + b) // 2
            name = "no host call"
            # the latest-starting call that covers the midpoint; calls nest,
            # so a short look back finds it
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 4096, -1), -1):
                if spans[j][1] >= mid:
                    name = spans[j][2]
                    break
            by[name[:120]] += length
        return [[k, v / 1e9] for k, v in by.most_common(n)]
