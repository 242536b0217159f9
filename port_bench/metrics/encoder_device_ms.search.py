"""Device milliseconds a batch of the text tower in the traced window: every
device operation launched inside ``CLIPRetrieval._encode_ids`` (the int8
layers B1, the embedding, the final LayerNorm, the projection, the
normalization)."""


def read(run):
    r = run.reduction
    n = run.traced.counts.get("batches", 0) if run.traced else 0
    if r is None or not n or "encode" not in r.device_s:
        return None
    return r.device_s["encode"] / n * 1e3
