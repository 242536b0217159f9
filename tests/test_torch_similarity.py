"""Port's blended top-k scan (B2) held to the JAX Pallas kernel.

The JAX side runs ``fused_similarity_topk{,_q8}`` with the Pallas kernel in
interpret mode and a tile that leaves a ragged last tile; the port runs its
plain version on the CPU. Values match to rtol 1e-5 (the same f32 products
summed in another order); indices match exactly on inputs without near
ties, and the tie, NaN and k > 128 cases pin the selection rules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.ops import similarity as J
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as T

N, Q, D = 1000, 8, 64
_F32_MIN = float(np.finfo(np.float32).min)


def _norm(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _data(rng, n=N):
    return _norm(rng.standard_normal((Q, D))), _norm(rng.standard_normal((n, D))), _norm(rng.standard_normal((n, D)))


def _alpha(rng, per_query):
    return rng.uniform(0.1, 0.9, Q).astype(np.float32) if per_query else 0.3


def _run_exact(q, img, txt, k, alpha, dtype):
    jd, td = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jv, ji = J.fused_similarity_topk(
        jnp.asarray(q, jd), jnp.asarray(img, jd), jnp.asarray(txt, jd), k, alpha=jnp.asarray(alpha),
        tile_n=256, interpret=True,
    )
    tv, ti = T.fused_similarity_topk(
        torch.tensor(q).to(td), torch.tensor(img).to(td), torch.tensor(txt).to(td), k,
        alpha=torch.tensor(alpha),
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("k", [1, 10])
def test_exact_topk_matches_pallas(rng, k, per_query, dtype):
    q, img, txt = _data(rng)
    (jv, ji), (tv, ti) = _run_exact(q, img, txt, k, _alpha(rng, per_query), dtype)
    assert tv.dtype == np.float32 and ti.dtype == np.int32 and tv.shape == (Q, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("k", [1, 10])
def test_q8_topk_matches_pallas(rng, k, per_query):
    q, img, txt = _data(rng)
    alpha = _alpha(rng, per_query)
    ji_q, ji_s = J.quantize_corpus_host(img)
    jt_q, jt_s = J.quantize_corpus_host(txt)
    ti_q, ti_s = T.quantize_corpus_host(img)
    tt_q, tt_s = T.quantize_corpus_host(txt)
    np.testing.assert_array_equal(ti_q, np.asarray(ji_q))
    np.testing.assert_array_equal(ti_s, np.asarray(ji_s))
    jv, ji = J.fused_similarity_topk_q8(
        jnp.asarray(q, jnp.bfloat16), ji_q, ji_s, jt_q, jt_s, k, alpha=jnp.asarray(alpha),
        tile_n=256, interpret=True,
    )
    t = lambda a: torch.tensor(np.asarray(a))  # noqa: E731
    tv, ti = T.fused_similarity_topk_q8(
        t(q).bfloat16(), t(ti_q), t(ti_s), t(tt_q), t(tt_s), k, alpha=torch.tensor(alpha)
    )
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def test_exact_ties_go_to_lowest_row(rng):
    q, img, txt = _data(rng)
    # rows 700 and 300 duplicate row 40 in both towers: three equal scores
    for r in (700, 300):
        img[r], txt[r] = img[40], txt[40]
    q[:] = (img[40] + txt[40]) / 2  # every query ranks the triple first
    (jv, ji), (tv, ti) = _run_exact(q, img, txt, 10, 0.5, "float32")
    np.testing.assert_array_equal(ti[:, :3], np.tile([40, 300, 700], (Q, 1)))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)


def test_nan_query_returns_row_zero(rng):
    q, img, txt = _data(rng)
    q[3] = np.nan
    (jv, ji), (tv, ti) = _run_exact(q, img, txt, 10, 0.5, "float32")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ti[3], np.zeros(10, np.int32))
    np.testing.assert_array_equal(tv[3], np.full(10, _F32_MIN, np.float32))
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)


def test_big_k_segmented(rng):
    q, img, txt = _data(rng, n=5000)  # > one 4096 segment, ragged
    k = 150
    (jv, ji), (tv, ti) = _run_exact(q, img, txt, k, 0.5, "float32")
    assert tv.shape == (Q, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)


def test_k_clamps_to_corpus(rng):
    q, img, txt = _data(rng, n=7)
    (jv, ji), (tv, ti) = _run_exact(q, img, txt, 10, 0.5, "float32")
    assert tv.shape == (Q, 7)
    np.testing.assert_array_equal(ti, ji)


def test_alpha_length_checked():
    with pytest.raises(ValueError):
        T.alpha_column([0.1, 0.2], 3, "cpu")


def _alpha_column_as_before(alpha, n_queries, device):
    """The column as it was built before it stopped waiting for a card: one
    ``torch.as_tensor`` onto the device."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    return a.expand(n_queries, 1).contiguous() if a.ndim == 0 else a.reshape(-1, 1).contiguous()


ALPHA_INPUTS = {
    "float": 0.1,
    "int": 1,
    "np_float32": np.float32(0.7),
    "np_float64": np.float64(0.3),
    "np_0d": np.array(0.25),
    "list": [0.1, 0.2, 0.9],
    "np_f32": np.array([0.3, 0.5, 0.7], np.float32),
    "np_f64": np.array([0.3, 0.1, 1 / 3]),
    "np_column": np.array([[0.2], [0.4], [0.6]], np.float32),
    "tensor": torch.tensor([0.2, 0.4, 0.6]),
    "tensor_f64": torch.tensor([0.2, 0.4, 1 / 3], dtype=torch.float64),
    "tensor_0d": torch.tensor(0.35),
}


@pytest.mark.parametrize("alpha", list(ALPHA_INPUTS.values()), ids=list(ALPHA_INPUTS))
def test_alpha_column_is_the_column_it_was(alpha):
    got = T.alpha_column(alpha, 3, "cpu")
    want = _alpha_column_as_before(alpha, 3, "cpu")
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == (3, 1)
    assert got.device == want.device and got.is_contiguous()
    assert torch.equal(got, want)  # bit for bit


def test_alpha_column_passes_a_tensor_on_the_device_as_it_is():
    a = torch.tensor([0.2, 0.4, 0.6])
    assert T.alpha_column(a, 3, "cpu").data_ptr() == a.data_ptr()
    assert T.alpha_column(a, 3, torch.device("cpu")).data_ptr() == a.data_ptr()


@pytest.mark.parametrize(
    "n_rows,query_blocks,blocks_wanted,want",
    [
        (43_000, 2, 132, 66),  # 256 queries in blocks of 128: one block an SM
        (43_300, 1, 132, 132),  # 64 image queries
        (100, 1, 132, 1),  # one tile: one strip
        (1_000_000, 2, 132, 66),
        (4_321, 3, 396, 34),  # never more strips than 128-row tiles
        (43_000, 200, 132, 1),  # more query blocks than blocks wanted: one strip each
    ],
)
def test_scan_strips_fill_the_card_without_empty_strips(n_rows, query_blocks, blocks_wanted, want):
    """The kernel's grid is (strips, query blocks) of about the SM count; a
    strip holds at least one 128-row tile."""
    got = T.scan_strips(n_rows, query_blocks, blocks_wanted)
    assert got == want
    assert 1 <= got <= -(-n_rows // 128)


@pytest.mark.parametrize("n_strips", [1, 3, 8])
@pytest.mark.parametrize("k", [1, 5, 20])
def test_strip_lists_then_merge_is_the_global_topk(rng, n_strips, k):
    """What the kernel's two passes compute, in plain PyTorch: each strip of
    tiles keeps its own k best (value descending, row ascending), and the
    merge of the strips' lists is the top-k of the whole corpus, ties across
    strips to the lowest row."""
    q, img, txt = _data(rng)
    img[900], txt[900] = img[17], txt[17]  # equal rows, far enough apart for different strips
    img[450], txt[450] = img[17], txt[17]
    q[0] = (img[17] + txt[17]) / 2
    scores = T.blended_scores(torch.tensor(q), torch.tensor(img), torch.tensor(txt), 0.5)
    n_tiles = -(-N // 128)
    bounds = [s * n_tiles // n_strips * 128 for s in range(n_strips)] + [N]
    vals, rows = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        v, i = T.topk_plain(scores[:, lo:hi], min(k, hi - lo))
        vals.append(v)
        rows.append(i.long() + lo)
    cand_v, cand_i = torch.cat(vals, 1), torch.cat(rows, 1)
    # the merge's order: value descending, then row ascending
    order = np.lexsort((cand_i.numpy(), -cand_v.numpy()), axis=1)[:, :k]
    got_v = np.take_along_axis(cand_v.numpy(), order, 1)
    got_i = np.take_along_axis(cand_i.numpy(), order, 1)
    want_v, want_i = T.topk_plain(scores, k)
    np.testing.assert_array_equal(got_v, want_v.numpy())
    np.testing.assert_array_equal(got_i, want_i.numpy())
    if k >= 3:
        assert got_i[0, :3].tolist() == [17, 450, 900]
