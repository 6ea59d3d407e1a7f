"""The host's launch calls (kernels issued one by one, and graph replays)
in the traced segment, a generated token."""


def read(cell, window, traced, trace):
    if not traced.get("units"):
        return None
    return trace.host_launches() / traced["units"]
