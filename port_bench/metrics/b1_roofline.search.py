"""The int8 layer kernel B1's share of its roofline: the least time of
every launch at its shape (``yardstick.layer_bounds``), over the device time
of the operations launched inside ``fused_layer_q8``, in the traced
window."""

from port_bench.yardstick import layer_bounds


def read(run):
    r, w = run.reduction, run.traced
    if r is None or not w.calls.get("b1") or not r.device_s.get("b1"):
        return None
    least = sum(layer_bounds(rows, width, ff, seq, mask, True)["B1"][0] for rows, width, ff, seq, mask in w.calls["b1"])
    return 100.0 * least / r.device_s["b1"]
