"""The host's time to issue a training step: the median duration of the
traced segment's ``train.step`` spans (``Trainer.train_step`` with
``sync=False``: staging the batch, the forward, ``autograd.grad`` and the
optimizer's update, issued without waiting for the card), in ms."""

import statistics

from perfbench.metrics.slot_occupancy import program_spans


def reading(spans):
    steps = [(s.end_ns - s.start_ns) / 1e6 for s in spans
             if s.name == "train.step"]
    return statistics.median(steps) if steps else None


def read(cell, window, traced, trace):
    spans = program_spans(trace)
    return None if spans is None else reading(spans)
