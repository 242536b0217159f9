"""The benchmark's arithmetic against numbers worked out by hand at each
cell's shapes."""

import json
from pathlib import Path

import pytest

from port_bench import gen, yardstick as y

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def arch(name):
    return gen.Arch.from_config(json.loads((CONFIGS / f"{name}.json").read_text()))


@pytest.mark.parametrize("name,grid,tokens", [("clip-vit-l14", 16, 257), ("clip-vit-l14-336", 24, 577)])
def test_train_flops_by_hand(name, grid, tokens):
    a = arch(name)
    b = 64
    patch = 2 * b * grid * grid * (3 * 14 * 14) * 1024
    vision = patch + 24 * (24 * b * tokens * 1024 * 1024) + 2 * b * 1024 * 768
    text = 2 * (12 * (24 * b * 77 * 768 * 768) + 2 * b * 768 * 768)
    attention = 4 * b * (24 * tokens * tokens * 1024 + 2 * 12 * 77 * 77 * 768)
    assert y.forward_flops(a, b) == {"vision": vision, "text": text, "attention": attention}
    assert y.model_step_flops(a, b) == 3 * (vision + text + attention)


def test_train_flops_224_is_36_tflop():
    assert y.model_step_flops(arch("clip-vit-l14"), 64) == pytest.approx(36.216e12, rel=1e-4)
    assert y.model_step_flops(arch("clip-vit-l14-336"), 64) == pytest.approx(78.436e12, rel=1e-4)


def test_b1_bound_text_batch_by_hand():
    # 256 queries at the 32 bucket (all 32 rows a sequence seen, causal), ViT-L/14 text layer
    rows, w, ff, s = 256 * 32, 768, 3072, 32
    proj = 2 * rows * (4 * w * w + 2 * w * ff)  # int8 products
    attn = 4 * rows * w * (s + 1) / 2  # bf16 q.k and p.v over the causal keys
    t_ops = proj / 1979e12 + attn / 989e12
    bytes_ = 2 * rows * w * 2 + (4 * w * w + 2 * w * ff) + 4 * (5 * w + ff) + 4 * (6 * w + ff)
    assert bytes_ / 3.35e12 < t_ops
    got, by = y.layer_bounds(rows, w, ff, s, s, True)["B1"]
    assert by == "operations" and got == pytest.approx(t_ops, rel=1e-12)


def test_b2_q8_bound_1m_rows_by_hand():
    q, n, d, k = 256, 1_000_000, 768, 20
    bytes_ = 2 * n * (d + 4) + q * d * 2 + q * 4 + q * k * 8
    ops = 2 * 2 * q * n * d
    got, by = y.topk_bound(q, n, d, k, d + 4)
    assert by == "operations"
    assert got == pytest.approx(max(bytes_ / 3.35e12, ops / 989e12), rel=1e-12)
    assert got * 1e3 == pytest.approx(0.7952, abs=1e-4)  # ms


@pytest.mark.parametrize("s,ms", [(257, 0.04022), (577, 0.09030)])
def test_flash_bound_by_hand(s, ms):
    b, h, d = 64, 16, 64
    bytes_ = 4 * b * h * s * d * 2
    got, by = y.attention_bound(b, h, s, d)
    assert by == "bytes" and got == pytest.approx(bytes_ / 3.35e12, rel=1e-12)
    assert got * 1e3 == pytest.approx(ms, abs=1e-5)


def test_percentile_and_spread():
    v = list(range(1, 101))
    assert y.percentile(v, 95) == 95
    assert y.percentile([3.0], 95) == 3.0
    assert y.spread([1, 2, 3, 4, 5]) == pytest.approx((4.5 - 1.5) / 3)
