"""The flash attention kernel's (B6 at 257 tokens, B7 at 577) share of its
roofline: the least time of every forward launch at its shape
(``yardstick.attention_bound``), over the device time of the operations
launched inside ``flash_attention_kernel``, in the traced window."""

from port_bench.yardstick import attention_bound


def read(run):
    r, w = run.reduction, run.traced
    if r is None or not w.calls.get("flash") or not r.device_s.get("flash"):
        return None
    least = sum(attention_bound(b, h, s, d)[0] for b, h, s, d in w.calls["flash"])
    return 100.0 * least / r.device_s["flash"]
