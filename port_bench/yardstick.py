"""The benchmark's arithmetic: published peaks, roofline bounds, FLOP counts,
percentiles and spreads.

Copied from the port's own measuring code so that a later change to the
program cannot move the yardstick: ``bound``, ``layer_bounds``,
``topk_bound`` and ``attention_bound`` from ``chip_smoke.py``, and the
forward FLOPs of a CLIP training step from the port's
``scripts/train_bench.py``. A bound counts every input byte read once and
every output byte written once, and each multiply-add as two operations,
whatever the kernel that runs the work.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

# One NVIDIA H100 SXM at its full 700 W limit (NVIDIA's data sheet, dense):
# device memory bytes/s, bf16 and int8 tensor-core operations/s, f32
# operations/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12
INT8_OPS_S = 1979e12
F32_OPS_S = 67e12


def bound(bytes_moved: float, ops: Sequence[Tuple[float, float]]) -> Tuple[float, str]:
    """``(seconds, bound_by)``: the least time the card could take for
    ``bytes_moved`` and ``ops``, a list of (operations, peak rate)."""
    t_bytes = bytes_moved / HBM_BYTES_S
    t_ops = sum(n / rate for n, rate in ops)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def layer_bounds(rows: int, width: int, ff: int, seq_len: int, mask_len: int, causal: bool) -> Dict[str, Tuple[float, str]]:
    """Bounds of one residual layer at one shape (``rows`` = sequences x
    padded length). Attention: q.k and p.v over the keys a row may see
    (``mask_len`` of them; on average (keys + 1) / 2 when causal)."""
    keys = min(seq_len, mask_len)
    attn = 4 * rows * width * ((keys + 1) / 2 if causal else keys)
    act = 2 * rows * width * 2  # x read, out written, bf16
    small = 4 * (6 * width + ff)  # LayerNorm vectors and biases, f32
    wa, wm = 4 * width * width, 2 * width * ff  # weight elements of the two halves
    scales = 4 * (5 * width + ff)  # f32 per-output-channel scales
    pa, pm = 2 * rows * wa, 2 * rows * wm  # projection operations of the two halves
    return {
        "B3a": bound(act + 2 * wa + small, [(pa + attn, BF16_OPS_S)]),
        "B3b": bound(act + 2 * wm + small, [(pm, BF16_OPS_S)]),
        "B1": bound(act + wa + wm + scales + small, [(pa + pm, INT8_OPS_S), (attn, BF16_OPS_S)]),
    }


def layer_ops(rows: int, width: int, ff: int, seq_len: int, mask_len: int, causal: bool) -> List[Tuple[float, float]]:
    """The operations of one int8 layer (B1) as (operations, peak rate)."""
    keys = min(seq_len, mask_len)
    attn = 4 * rows * width * ((keys + 1) / 2 if causal else keys)
    proj = 2 * rows * (4 * width * width + 2 * width * ff)
    return [(proj, INT8_OPS_S), (attn, BF16_OPS_S)]


def topk_bound(q: int, n: int, d: int, k: int, corpus_bytes_per_row: float) -> Tuple[float, str]:
    """The blended top-k scan (B2) in every corpus mode: both towers' rows
    read once (``corpus_bytes_per_row`` each, scales included), the bf16
    queries and alpha read, k (value, row) pairs written; two q x n x d
    products at the bf16 rate (the queries are bf16)."""
    return bound(2 * n * corpus_bytes_per_row + q * d * 2 + q * 4 + q * k * 8, topk_ops(q, n, d))


def topk_ops(q: int, n: int, d: int) -> List[Tuple[float, float]]:
    return [(2 * 2 * q * n * d, BF16_OPS_S)]


def attention_bound(b: int, h: int, s: int, d: int) -> Tuple[float, str]:
    """Flash attention forward (B6 / B7): q, k, v read and o written (bf16);
    q.k and p.v over every key."""
    return bound(4 * b * h * s * d * 2, [(4 * b * h * s * s * d, BF16_OPS_S)])


def forward_flops(arch, batch: int) -> Dict[str, float]:
    """Forward FLOPs of one training step's towers by part: ``vision``,
    ``text`` (queries and targets, both at the full context) and
    ``attention`` (the scores of all three)."""
    s_v, s_t = arch.grid_size ** 2 + 1, arch.context_length
    w_v, w_t = arch.vision_width, arch.text_width
    patch = 2 * batch * arch.grid_size ** 2 * 3 * arch.vision_patch_size ** 2 * w_v
    vision = patch + arch.vision_layers * 24 * batch * s_v * w_v ** 2 + 2 * batch * w_v * arch.embed_dim
    text = 2 * (arch.text_layers * 24 * batch * s_t * w_t ** 2 + 2 * batch * w_t * arch.embed_dim)
    attention = 4 * batch * (arch.vision_layers * s_v ** 2 * w_v + 2 * arch.text_layers * s_t ** 2 * w_t)
    return {"vision": vision, "text": text, "attention": attention}


def model_step_flops(arch, batch: int) -> float:
    """Model FLOPs of one step: forward and backward, 3x the forward. A
    remat recompute is hardware work, not model work, and is not counted."""
    return 3 * sum(forward_flops(arch, batch).values())


def percentile(values: Iterable[float], p: float) -> float:
    """Nearest-rank percentile: the smallest value with at least ``p`` % of
    the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(p / 100.0 * len(v)))
    return v[rank - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile (Python's
    ``statistics.quantiles(values, n=4)``) as a share of the median."""
    import statistics

    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
