"""The search step's share of the card's peak: the int8 text layers' and the
scan's operations, each at the peak of its type (int8 projections at 1,979
TOP/s, attention and the bf16 scan products at 989 TFLOP/s), of every batch
of the measured window, over that window's length by the host's clock."""

from port_bench.yardstick import layer_ops, topk_ops


def read(run):
    w = run.plain
    b1, b2 = w.calls.get("b1"), w.calls.get("b2")
    if not b1 or not b2 or w.window_s <= 0:
        return None
    t = sum(n / rate for rows, width, ff, seq, mask in b1 for n, rate in layer_ops(rows, width, ff, seq, mask, True))
    t += sum(n / rate for q, rows, d, k in b2 for n, rate in topk_ops(q, rows, d))
    return 100.0 * t / w.window_s
