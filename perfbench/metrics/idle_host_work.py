"""The share of the card's idle time in the traced segment that the
engine's worker spent on host work: of the gaps between the device's
activities (from its first to its last), the part that lies under the
worker thread's ``engine.admit``, ``engine.chunk``, ``engine.harvest`` or
``engine.loop`` spans, each moment named by the innermost span over it,
in %. The worker's spans tile its loop, so the rest of the idle lies
under ``engine.wait_requests`` (no request to run), ``engine.harvest_wait``
(the host waiting on the card) or outside the worker's spans.

The full split by span, and two checks of the spans' clock, go to
standard error: the share of the trace's ``cudaGraphLaunch`` records that
lie inside an ``engine.chunk`` span to within 50 us (the worker issues
every graph replay of this cell), and the share of idle under
``engine.harvest_wait``."""

import bisect
import collections
import sys

from perfbench.metrics.slot_occupancy import program_spans

HOST_WORK = ("engine.admit", "engine.chunk", "engine.harvest",
             "engine.loop")
WORKER = HOST_WORK + ("engine.wait_requests", "engine.harvest_wait")
OUTSIDE = "outside the worker"
SLACK_NS = 50_000


def device_gaps(device) -> list:
    """[(start ns, end ns)] of the card's idle between the activities
    ``device`` [(name, start ns, duration ns)], in start order."""
    gaps, end = [], None
    for _, start, dur in device:
        if end is not None and start > end:
            gaps.append((end, start))
        end = start + dur if end is None else max(end, start + dur)
    return gaps


def innermost(spans) -> list:
    """The nested spans of one thread -> [(start ns, end ns, name)], pieces
    that do not overlap, each named by the innermost span over it."""
    out, stack, t = [], [], None
    for s in sorted(spans, key=lambda s: (s.start_ns, -s.end_ns)):
        while stack and stack[-1].end_ns <= s.start_ns:
            top = stack.pop()
            out.append((t, top.end_ns, top.name))
            t = top.end_ns
        if stack:
            out.append((t, s.start_ns, stack[-1].name))
        stack.append(s)
        t = s.start_ns
    while stack:
        top = stack.pop()
        out.append((t, top.end_ns, top.name))
        t = top.end_ns
    return [p for p in out if p[1] > p[0]]


def split(gaps, pieces) -> collections.Counter:
    """ns of ``gaps`` under each name of ``pieces`` (both sorted, neither
    overlapping itself), the rest under :data:`OUTSIDE`."""
    by, i = collections.Counter(), 0
    for a, b in gaps:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        covered, j = 0, i
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
            if hi > lo:
                by[pieces[j][2]] += hi - lo
                covered += hi - lo
            j += 1
        by[OUTSIDE] += (b - a) - covered
    return by


def launches_in_chunks(host_spans, chunks) -> tuple:
    """(``cudaGraphLaunch`` records of ``host_spans`` [(start, end, name)]
    inside one of ``chunks`` [(start, end)] to within 50 us, all of
    them)."""
    chunks = sorted(chunks)
    starts = [a for a, _ in chunks]
    inside = total = 0
    for a, b, name in host_spans:
        if name != "cudaGraphLaunch":
            continue
        total += 1
        k = bisect.bisect_right(starts, a + SLACK_NS) - 1
        if k >= 0 and chunks[k][0] - SLACK_NS <= a \
                and b <= chunks[k][1] + SLACK_NS:
            inside += 1
    return inside, total


def reading(spans, device, host_spans=(), log=None):
    chunks = [s for s in spans if s.name == "engine.chunk"]
    gaps = device_gaps(device)
    if not chunks or not gaps:
        return None
    tid = collections.Counter(s.tid for s in chunks).most_common(1)[0][0]
    worker = [s for s in spans if s.tid == tid and s.name in WORKER]
    by = split(gaps, innermost(worker))
    idle = sum(b - a for a, b in gaps)
    if log is not None:
        parts = ", ".join(f"{k} {v / 1e6:.3f} ms ({100.0 * v / idle:.2f}%)"
                          for k, v in by.most_common())
        log(f"[idle_host_work] device idle {idle / 1e6:.3f} ms in "
            f"{len(gaps)} gaps, by the worker's innermost span: {parts}; "
            f"the split sums to {100.0 * sum(by.values()) / idle:.3f}%, the "
            f"worker's spans cover {100.0 * (idle - by[OUTSIDE]) / idle:.3f}%")
        inside, total = launches_in_chunks(
            host_spans, [(s.start_ns, s.end_ns) for s in chunks])
        log(f"[idle_host_work] clock: {inside} of {total} cudaGraphLaunch "
            f"records inside an engine.chunk span to within 50 us; idle "
            f"under engine.harvest_wait "
            f"{100.0 * by['engine.harvest_wait'] / idle:.3f}%")
    return 100.0 * sum(by[k] for k in HOST_WORK) / idle


def read(cell, window, traced, trace):
    spans = program_spans(trace)
    if spans is None:
        return None
    return reading(spans, trace.device, trace.host_spans,
                   log=lambda m: print(m, file=sys.stderr, flush=True))
