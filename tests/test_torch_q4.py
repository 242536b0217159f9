"""Port's int4 scan (B2's q4 mode) and the shared capacity-tier helpers,
held to the JAX package.

The JAX side runs ``fused_similarity_topk_q4`` with the Pallas kernel in
interpret mode (a tile that leaves a ragged last tile); the port runs its
plain version on the CPU. Values match to rtol 1e-5, atol 1e-6 (the JAX
q4 tests' tolerance: the same f32 products summed in another order);
indices match exactly on inputs without near ties. The host helpers
(packing, rotation, prefix renormalization, rerank) are bit-equal.
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


def _t(a):
    return torch.tensor(np.asarray(a))


def _run_q4(q, img, txt, k, alpha, dtype="float32"):
    jd, td = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ip, is_ = T.quantize_corpus_host_q4(img)
    tp, ts = T.quantize_corpus_host_q4(txt)
    jv, ji = J.fused_similarity_topk_q4(
        jnp.asarray(q, jd), jnp.asarray(ip), jnp.asarray(is_), jnp.asarray(tp), jnp.asarray(ts), k,
        alpha=jnp.asarray(alpha), tile_n=256, interpret=True,
    )
    tv, ti = T.fused_similarity_topk_q4(
        _t(q).to(td), _t(ip), _t(is_), _t(tp), _t(ts), k, alpha=torch.tensor(alpha)
    )
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def test_q4_packing_bit_equal(rng):
    emb = rng.standard_normal((37, D)).astype(np.float32)
    emb[5] = 0.0  # a zero (pad) row
    jp, js = J.quantize_corpus_host_q4(emb)
    tp, ts = T.quantize_corpus_host_q4(emb)
    np.testing.assert_array_equal(tp, np.asarray(jp))
    np.testing.assert_array_equal(ts, np.asarray(js))
    lo, hi = T._unpack_q4(_t(tp), torch.float32)
    jlo, jhi = J._unpack_q4(jnp.asarray(jp), jnp.float32)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(
        T.dequantize_corpus_q4(_t(tp), _t(ts)).numpy(), np.asarray(J.dequantize_corpus_q4(jp, js))
    )
    with pytest.raises(ValueError, match="even"):
        T.quantize_corpus_host_q4(emb[:, :33])
    q8, s8 = T.quantize_corpus_host(emb)
    np.testing.assert_array_equal(
        T.dequantize_corpus(_t(q8), _t(s8)).numpy(), np.asarray(J.dequantize_corpus(jnp.asarray(q8), jnp.asarray(s8)))
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("k", [1, 10])
def test_q4_topk_matches_pallas(rng, k, per_query, dtype):
    q, img, txt = _data(rng)
    alpha = rng.uniform(0.1, 0.9, Q).astype(np.float32) if per_query else 0.3
    (jv, ji), (tv, ti) = _run_q4(q, img, txt, k, alpha, dtype)
    assert tv.dtype == np.float32 and ti.dtype == np.int32 and tv.shape == (Q, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)


def test_q4_scores_match_jax_oracle(rng):
    q, img, txt = _data(rng, n=300)
    ip, is_ = T.quantize_corpus_host_q4(img)
    tp, ts = T.quantize_corpus_host_q4(txt)
    want = J.blended_scores_q4(jnp.asarray(q), ip, is_, tp, ts, 0.4)
    got = T.blended_scores_q4(_t(q), _t(ip), _t(is_), _t(tp), _t(ts), 0.4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_q4_zero_pad_rows_and_nan_query(rng):
    q, img, txt = _data(rng)
    img[-24:] = 0.0  # capacity-pad rows: zero vectors, score exactly 0
    txt[-24:] = 0.0
    q[3] = np.nan
    (jv, ji), (tv, ti) = _run_q4(q, img, txt, 10, 0.5)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ti[3], np.zeros(10, np.int32))
    np.testing.assert_array_equal(tv[3], np.full(10, _F32_MIN, np.float32))


def test_q4_big_k_segmented(rng):
    q, img, txt = _data(rng, n=5000)  # > one 4096 segment, ragged
    (jv, ji), (tv, ti) = _run_q4(q, img, txt, 150, 0.5)
    assert tv.shape == (Q, 150)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dim", [8, 64, 96])
@pytest.mark.parametrize("seed", [0, 3])
def test_random_rotation_bit_equal(dim, seed):
    r = T.random_rotation(dim, seed)
    np.testing.assert_array_equal(r, J.random_rotation(dim, seed))
    np.testing.assert_allclose(r @ r.T, np.eye(dim), atol=1e-5)


def test_prefix_normalize_matches_jax(rng):
    x = rng.standard_normal((9, D)).astype(np.float32)
    x[4] = 0.0
    np.testing.assert_array_equal(T.prefix_normalize_host(x, 24), J.prefix_normalize_host(x, 24))
    np.testing.assert_allclose(
        T.prefix_normalize(_t(x), 24).numpy(), np.asarray(J.prefix_normalize(jnp.asarray(x), 24)), rtol=1e-6, atol=1e-7
    )
    with pytest.raises(ValueError, match="truncate dim"):
        T.prefix_normalize_host(x, D + 1)


@pytest.mark.parametrize("per_query", [False, True])
def test_rerank_scores_host_bit_equal(rng, per_query):
    q, img, txt = _data(rng, n=200)
    idx = rng.integers(0, 200, (Q, 12))
    idx[2, 5:] = -1  # ann sentinels
    alpha = rng.uniform(0.1, 0.9, Q).astype(np.float32) if per_query else 0.7
    tv, ti = T.rerank_scores_host(q, img, txt, idx, alpha)
    jv, ji = J.rerank_scores_host(q, img, txt, idx, alpha)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    assert np.isneginf(tv[2, 5:]).all()
