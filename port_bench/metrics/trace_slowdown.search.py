"""How much slower the traced window ran than the measured one: batches a
second without the profiler over batches a second under it. The idle share
and the idle gaps are the traced window's; this is the factor by which the
profiler's host cost inflates them."""


def read(run):
    a, b = run.plain, run.traced
    if b is None or not a.counts.get("batches") or not b.counts.get("batches") or a.window_s <= 0 or b.window_s <= 0:
        return None
    return (a.counts["batches"] / a.window_s) / (b.counts["batches"] / b.window_s)
