"""The whole step's share of the card's peak: ``work.py``'s model
operations for the window's completed work, over the window, over the
peak of the model's dtype (989 TFLOP/s bf16, 67 TFLOP/s f32 with TF32
off), in %."""

from perfbench import work


def read(cell, window, traced, trace):
    if not window.get("flops") or not window.get("wall_s"):
        return None
    peak = work.PEAK_FLOPS[window["dtype"]]
    return 100.0 * window["flops"] / window["wall_s"] / peak
