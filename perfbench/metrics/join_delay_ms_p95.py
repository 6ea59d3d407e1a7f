"""The engine's join delay, p95 over the window's requests: from
``submit`` to the row's admission, as ``ContinuousBatcher.stats
["join_delay_ms"]`` records it (``serve/continuous.py``)."""

from perfbench import core


def read(cell, window, traced, trace):
    joins = window.get("join_delay_ms")
    return core.percentile(joins, 95) if joins else None
