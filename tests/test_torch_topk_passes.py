"""The scan kernels' selection above k = 128, held on the CPU.

A CUDA tensor runs B2 / B5 at every k: up to ``KERNEL_PASS_K`` rows a pass,
and a larger k as passes, each under the ceiling (the last value and row) of
the pass before. The kernels run only on the card; here their plain pass
logic is held to the plain top-k, B5's LUT re-layout to the JAX package's
``pq_luts``, and the CUDA routes (with the wrappers faked) are checked to
reach the kernels, never the materialized-score selections.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.ops import pq as J
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import pq as PQ
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as S

_F32_MIN = float(np.finfo(np.float32).min)


def _scores(n, q=6, seed=0, finite=None):
    """Random scores with exact ties (every 7th column repeats column 0), a
    NaN query, and optionally only ``finite`` finite rows per query."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((q, n)).astype(np.float32)
    s[:, ::7] = s[:, :1]
    s[2] = np.nan
    if finite is not None:
        s[:, finite:] = np.nan
    return torch.tensor(s)


@pytest.mark.parametrize("k", [130, 400, 1000])
@pytest.mark.parametrize("finite", [None, 90])
def test_passes_concatenated_equal_the_plain_topk(k, finite):
    scores = _scores(3000, finite=finite)
    got = S.topk_passes_plain(scores, k)
    want = S.topk_plain(scores, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int32 and got[0].shape == (6, k)
    assert (got[1][2] == 0).all() and (got[0][2] == _F32_MIN).all()


@pytest.mark.parametrize("k,want", [(1, (1, 1)), (400, (1, 400)), (512, (1, 512)), (513, (2, 257)),
                                    (1000, (2, 500)), (1025, (3, 342))])
def test_pass_sizes_are_equal_and_at_most_one_kernel_pass(k, want):
    passes, per = S.pass_sizes(k)
    assert (passes, per) == want
    assert per <= S.KERNEL_PASS_K and passes * per >= k > (passes - 1) * per


def test_a_pass_that_ends_in_fillers_ends_the_run():
    """Fewer finite rows than the first pass holds: the second pass is never
    launched, and the rest of the result is fillers (float32 min, row 0)."""
    scores = _scores(2000, finite=300)
    calls = []

    def launch(kp, ceil_v, ceil_r):
        calls.append(ceil_v)
        return S.topk_plain(scores, kp)

    got = S.topk_passes(launch, 6, 1000, scores.device)
    want = S.topk_plain(scores, 1000)
    assert len(calls) == 1 and calls[0] is None
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("qn,n_k", [(37, 100), (16, 256), (5, 32)])
def test_lut_interleave_maps_back_to_the_jax_luts(qn, n_k):
    """B5's operand layout is a plain permute of the JAX package's LUT: it
    maps back bit for bit, and entry [g, m, c] holds queries 16 g .. 16 g +
    15 of (m, c), its two halves swapped where bit 2 of c is set."""
    rng = np.random.default_rng(qn)
    m, ds = 8, 4
    q = rng.standard_normal((qn, m * ds)).astype(np.float32)
    cb = rng.standard_normal((m, n_k, ds)).astype(np.float32)
    lut = torch.tensor(np.asarray(J.pq_luts(jnp.asarray(q), jnp.asarray(cb)).astype(jnp.float32))).bfloat16()
    x = PQ.pq_lut_interleave(lut)
    assert x.shape == (-(-qn // 16), m, n_k, 16) and x.is_contiguous()
    back = PQ._swap_halves(x).permute(1, 0, 3, 2).reshape(m, 16 * x.shape[0], n_k)[:, :qn]
    assert torch.equal(back, lut)
    padded = torch.nn.functional.pad(lut, (0, 0, 0, 16 * x.shape[0] - qn))
    for c in (0, 3, 4, n_k - 1):
        entry = padded[2, :16, c]
        want = torch.cat([entry[8:], entry[:8]]) if c & 4 else entry
        assert torch.equal(x[0, 2, c], want)


@pytest.mark.parametrize("fn", ["exact", "q8", "q4"])
def test_cuda_route_launches_b2_at_every_k(monkeypatch, fn):
    """With the device check and the kernel wrapper faked, k = 400 reaches
    the kernel wrapper and never the segmented selection."""
    calls = []
    monkeypatch.setattr(dispatch, "use_kernel", lambda t: True)
    monkeypatch.setattr(S, "_segmented_topk_from_scores", lambda *a, **k: pytest.fail("segmented route"))

    def fake(qi, qt, img, txt, si, st, a, k, q4=False):
        calls.append((k, q4))
        return torch.zeros((qi.shape[0], k)), torch.zeros((qi.shape[0], k), dtype=torch.int32)

    monkeypatch.setattr(S, "similarity_topk_kernel", fake)
    q = torch.randn(3, 8).bfloat16()
    if fn == "exact":
        S.fused_similarity_topk(q, torch.randn(500, 8).bfloat16(), torch.randn(500, 8).bfloat16(), 400)
    else:
        d = 4 if fn == "q4" else 8
        c = (torch.zeros(500, d, dtype=torch.int8), torch.ones(500, 1)) * 2
        (S.fused_similarity_topk_q8 if fn == "q8" else S.fused_similarity_topk_q4)(q, *c, 400)
    assert calls == [(400, fn == "q4")]


def test_cuda_route_launches_b5_at_every_k(monkeypatch):
    """``pq_similarity_topk`` on a CUDA tensor calls B5's wrapper at k = 400
    (``fused_pq_topk`` keeps the JAX refusal above 128) and never the plain
    ADC route."""
    calls = []
    monkeypatch.setattr(dispatch, "use_kernel", lambda t: True)
    monkeypatch.setattr(PQ, "pq_similarity_topk_adc", lambda *a, **k: pytest.fail("plain ADC route"))

    def fake(a, lut_i, lut_t, ci, si, ct, st, k):
        calls.append((k, tuple(lut_i.shape)))
        return torch.zeros((lut_i.shape[1], k)), torch.zeros((lut_i.shape[1], k), dtype=torch.int32)

    monkeypatch.setattr(PQ, "pq_adc_topk_kernel", fake)
    m, n_k, ds, n = 4, 16, 2, 600
    codes = torch.zeros((n, m), dtype=torch.uint8)
    scale = torch.ones(n, 1)
    cb = torch.randn(m, n_k, ds)
    q = torch.randn(3, m * ds)
    PQ.pq_similarity_topk(q, codes, scale, codes, scale, cb, cb, 400)
    assert calls == [(400, (m, 3, n_k))]
    with pytest.raises(ValueError, match="caps k"):
        PQ.fused_pq_topk(q, codes, scale, codes, scale, cb, cb, 129)


@pytest.mark.parametrize(
    "n_rows,query_blocks,want",
    [(43_000, 16, 8), (1_000_000, 16, 8), (3001, 2, 3), (43_000, 200, 1)],
)
def test_b5_strips_of_1024_row_tiles(n_rows, query_blocks, want):
    """B5's grid: strips of 1024-row tiles x 16-query groups, about one block
    an SM (132), never more strips than tiles."""
    assert S.scan_strips(n_rows, query_blocks, 132, tile=1024) == want
