"""The engine's slot occupancy: the live rows times the steps of each
``engine.chunk`` span of the traced segment, over its slots times its
steps, summed over the chunks, in %. A row counts as live from its
admission to the harvest that frees its slot, so a finished row the
harvest has not reached yet still holds its slot (``serve/
continuous.py``). :func:`program_spans` finds the program's spans for
every reader of them."""


def program_spans(trace):
    """The spans the program recorded in the traced segment
    (``eamg_tpu_torch.utils.logging.spans``), or None where the segment put
    nothing on a card or the program records no spans."""
    if not trace.device:
        return None
    try:
        from eamg_tpu_torch.utils.logging import spans
    except ImportError:
        return None
    return spans() or None


def reading(spans):
    chunks = [s.counts for s in spans if s.name == "engine.chunk"]
    slot_steps = sum(c["slots"] * c["steps"] for c in chunks)
    if not slot_steps:
        return None
    return 100.0 * sum(c["rows"] * c["steps"] for c in chunks) / slot_steps


def read(cell, window, traced, trace):
    spans = program_spans(trace)
    return None if spans is None else reading(spans)
