"""Device milliseconds a batch of the blended top-k over the corpus in the
traced window: every device operation launched inside
``CLIPRetrieval._score``."""


def read(run):
    r = run.reduction
    n = run.traced.counts.get("batches", 0) if run.traced else 0
    if r is None or not n or "scan" not in r.device_s:
        return None
    return r.device_s["scan"] / n * 1e3
