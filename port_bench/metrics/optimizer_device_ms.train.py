"""Device milliseconds a step of the optimizer in the traced window: every
device operation launched inside ``train.trainer.Optimizer.step`` (the clip
and AdamW)."""


def read(run):
    r = run.reduction
    n = run.traced.counts.get("steps", 0) if run.traced else 0
    if r is None or not n or "optimizer" not in r.device_s:
        return None
    return r.device_s["optimizer"] / n * 1e3
