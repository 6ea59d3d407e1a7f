"""Device activities (kernels and copies, graph replays' included) in the
traced segment, a unit of the runner's: a generated token in the decode
cells (``kernels_per_step`` reads a training step with it)."""


def read(cell, window, traced, trace):
    if not traced.get("units") or not trace.device:
        return None
    return len(trace.device) / traced["units"]
