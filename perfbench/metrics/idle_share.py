"""The device's idle share: 1 - (device busy a unit in the traced
segment) / (wall time a unit over the untraced work of the same run), in
%. A unit is a generated token, or a training step. The untraced work is
the window, or where the runner ran one the traced segment's untraced twin
(``idle_units`` over ``idle_wall_s``: the engine's segment ramps up and
drains, the window does not). Against an untraced wall, so the profiler's
own host cost does not count as idle."""


def read(cell, window, traced, trace):
    units = window.get("idle_units", window.get("units"))
    if not traced.get("units") or not units or not trace.device:
        return None
    busy = trace.busy_s / traced["units"]
    wall = window.get("idle_wall_s", window.get("wall_s")) / units
    return 100.0 * (1.0 - busy / wall)
