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
