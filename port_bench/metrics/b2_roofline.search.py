"""The blended top-k kernel B2 (int8 corpus) share of its roofline: the
least time of every launch (``yardstick.topk_bound``: an int8 row and its
f32 scale a tower), over the device time of the operations launched inside
``fused_similarity_topk_q8``, in the traced window."""

from port_bench.yardstick import topk_bound


def read(run):
    r, w = run.reduction, run.traced
    if r is None or not w.calls.get("b2") or not r.device_s.get("b2"):
        return None
    least = sum(topk_bound(q, n, d, k, d + 4)[0] for q, n, d, k in w.calls["b2"])
    return 100.0 * least / r.device_s["b2"]
