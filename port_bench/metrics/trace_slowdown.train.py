"""How much slower the traced window ran than the measured one: steps a
second without the profiler over steps a second under it. The idle share
and the idle gaps are the traced window's; this is the factor by which the
profiler's host cost inflates them."""


def read(run):
    a, b = run.plain, run.traced
    if b is None or not a.counts.get("steps") or not b.counts.get("steps") or a.window_s <= 0 or b.window_s <= 0:
        return None
    return (a.counts["steps"] / a.window_s) / (b.counts["steps"] / b.window_s)
