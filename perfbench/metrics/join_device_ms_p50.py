"""The engine's join as the card sees it, the median over the traced
segment's requests: each ``engine.join`` span, from ``submit`` to the end
of the worker's wait on the snapshot of the chunk its prefill queued
behind (or the prefill's issue where no chunk was in flight). The segment
holds a few dozen requests, too few for a p95. The count, and the median
of the join the host sees (``submit`` to the end of ``engine.admit``, as
``join_delay_ms`` counts it), go to standard error."""

import statistics
import sys

from perfbench.metrics.slot_occupancy import program_spans


def reading(spans, log=None):
    joins = [(s.end_ns - s.start_ns) / 1e6 for s in spans
             if s.name == "engine.join"]
    if not joins:
        return None
    queued = {s.rid: s.start_ns for s in spans if s.name == "engine.queue"}
    host = [(s.end_ns - queued[s.rid]) / 1e6 for s in spans
            if s.name == "engine.admit" and s.rid in queued]
    if log is not None:
        log(f"[join_device_ms_p50] {len(joins)} joins; the host's join "
            f"(submit to the admission's issue) p50 "
            f"{statistics.median(host) if host else 'none'} ms over "
            f"{len(host)}")
    return statistics.median(joins)


def read(cell, window, traced, trace):
    spans = program_spans(trace)
    if spans is None:
        return None
    return reading(spans, log=lambda m: print(m, file=sys.stderr,
                                              flush=True))
