"""The share of the engine's live row-steps that made a token: the tokens
the traced segment's ``engine.harvest`` spans found, over the live rows
times the steps of its ``engine.chunk`` spans, in %. A finished row keeps
stepping inertly in its slot until the harvest after the next chunk frees
it; those steps make no token."""

from perfbench.metrics.slot_occupancy import program_spans


def reading(spans):
    live = sum(s.counts["rows"] * s.counts["steps"] for s in spans
               if s.name == "engine.chunk")
    if not live:
        return None
    return 100.0 * sum(s.counts["tokens"] for s in spans
                       if s.name == "engine.harvest") / live


def read(cell, window, traced, trace):
    spans = program_spans(trace)
    return None if spans is None else reading(spans)
