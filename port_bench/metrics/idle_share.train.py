"""Share of the traced training window in which no device operation ran. The
profiler slows the host's side of that window (``trace_slowdown.train``
says by how much), so this reads above the measured window's idle share."""


def read(run):
    r = run.reduction
    if r is None or r.window_s <= 0 or not r.n_device_ops:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)
