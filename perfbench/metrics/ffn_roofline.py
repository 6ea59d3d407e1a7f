"""K2's share of its roofline: ``work.py``'s least bytes (W1, W2 and both
biases once a launch, the rows in and out once) at 3.35 TB/s, over the
device time of K2's kernel (``ops/ffn.py`` -> ``csrc/ffn.cu``), in %."""

from perfbench import work

KERNELS = ("ffn_grid_kernel",)


def read(cell, window, traced, trace):
    seconds, count = trace.device_seconds(KERNELS)
    if not count or not traced.get("ffn_rows"):
        return None
    g = work.geometry({"model": cell.model()})
    n = work.ffn_bytes(g, count, traced["ffn_rows"], window["dtype"])
    return 100.0 * n / work.PEAK_BYTES_PER_S / seconds
