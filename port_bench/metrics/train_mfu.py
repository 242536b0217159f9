"""The training step's share of the card's bf16 peak (989 TFLOP/s): model
FLOPs, three times the forward (``yardstick.model_step_flops``; a remat
recompute is not counted), of every step of the measured window, over that
window's length by the host's clock."""

from port_bench.yardstick import BF16_OPS_S, model_step_flops


def read(run):
    w = run.plain
    n = w.counts.get("steps", 0)
    if not n or w.window_s <= 0:
        return None
    return 100.0 * n * model_step_flops(run.arch, int(run.traffic["batch"])) / BF16_OPS_S / w.window_s
