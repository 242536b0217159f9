"""Port's product-quantized tier (ops/pq.py, B5's plain version) held to the
JAX package.

Host training and encoding are the JAX package's NumPy code copied, so they
are held bit for bit. The ADC plain version is fed the JAX LUTs and held to
the JAX Pallas kernel in interpret mode at rtol 1e-5, atol 1e-6 (the JAX PQ
tests' tolerance); the decode path to ``pq_similarity_topk_xla`` at rtol
1e-5; the port's LUTs to the JAX ones within one bf16 step per entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.ops import pq as J
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import pq as T
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops.similarity import alpha_column

M, D = 8, 64
_F32_MIN = float(np.finfo(np.float32).min)


def _rows(n, d=D, seed=0, clusters=0):
    rng = np.random.default_rng(seed)
    if clusters:
        centers = rng.standard_normal((clusters, d)).astype(np.float32)
        x = centers[rng.integers(0, clusters, n)] + 0.15 * rng.standard_normal((n, d)).astype(np.float32)
    else:
        x = rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.fixture(scope="module")
def packed():
    img = _rows(300, seed=1, clusters=12)
    txt = _rows(300, seed=2, clusters=12)
    img[-6:] = 0.0  # zero pad rows pack to scale 0
    txt[-6:] = 0.0
    cb_img = T.train_pq_codebooks(img, m=M, k=32, iters=8, seed=0)
    cb_txt = T.train_pq_codebooks(txt, m=M, k=32, iters=8, seed=1)
    ci, si = T.pq_encode_host(img, cb_img)
    ct, st = T.pq_encode_host(txt, cb_txt)
    return img, txt, cb_img, cb_txt, ci, si, ct, st


@pytest.mark.parametrize("k,iters,seed", [(16, 5, 7), (256, 12, 0)])
def test_train_pq_codebooks_bit_equal(k, iters, seed):
    rows = _rows(400, seed=3)
    rows[7] = 0.0
    np.testing.assert_array_equal(
        T.train_pq_codebooks(rows, m=M, k=k, iters=iters, seed=seed),
        J.train_pq_codebooks(rows, m=M, k=k, iters=iters, seed=seed),
    )


def test_anisotropic_pq_bit_equal():
    rows = _rows(256, seed=4, clusters=6)
    assert T.anisotropic_eta(0.2, D) == J.anisotropic_eta(0.2, D)
    cb = T.train_pq_codebooks_anisotropic(rows, m=M, k=16, t=0.2, iters=2, passes=1, seed=2)
    np.testing.assert_array_equal(cb, J.train_pq_codebooks_anisotropic(rows, m=M, k=16, t=0.2, iters=2, passes=1, seed=2))
    padded = np.concatenate([rows[:40], np.zeros((3, D), np.float32)])
    for got, want in zip(T.pq_encode_host_anisotropic(padded, cb, t=0.2), J.pq_encode_host_anisotropic(padded, cb, t=0.2)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(T.pack_pq_host(padded, cb, aniso_t=0.2), J.pack_pq_host(padded, cb, aniso_t=0.2)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_opq_rotation_and_encode_bit_equal(packed):
    img, txt, cb_img, *_ = packed
    rows = np.concatenate([img, txt])
    r = T.train_opq_rotation(rows, m=M, k=16, opq_iters=2, kmeans_iters=2, seed=5)
    np.testing.assert_array_equal(r, J.train_opq_rotation(rows, m=M, k=16, opq_iters=2, kmeans_iters=2, seed=5))
    for got, want in zip(T.pq_encode_host(img, cb_img), J.pq_encode_host(img, cb_img)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(T.pack_pq_host(img, cb_img), J.pack_pq_host(img, cb_img)):
        np.testing.assert_array_equal(got, np.asarray(want))
    with pytest.raises(ValueError, match="divide"):
        T.train_pq_codebooks(img, m=7)


def test_pq_luts_within_one_bf16_step(packed):
    _, _, cb_img, *_ = packed
    q = _rows(12, seed=20)
    got = T.pq_luts(_t(q), _t(cb_img)).float().numpy()
    want = np.asarray(J.pq_luts(jnp.asarray(q), jnp.asarray(cb_img)).astype(jnp.float32))
    assert got.shape == want.shape == (M, 12, 32)
    step = np.maximum(np.abs(want), 2.0**-126) * 2.0**-7  # one bf16 ulp at each entry
    assert (np.abs(got - want) <= step).all()


@pytest.mark.parametrize("k", [1, 9, 128])
@pytest.mark.parametrize("per_query", [False, True])
def test_adc_plain_matches_pallas_kernel(packed, k, per_query):
    """B5's plain version, fed the JAX LUTs, selects what the Pallas kernel
    (interpret mode) selects."""
    _, _, cb_img, cb_txt, ci, si, ct, st = packed
    q = _rows(12, seed=20)
    q[4] = np.nan  # a NaN query: every score masked to f32 min, rows 0
    rng = np.random.default_rng(k)
    alpha = rng.uniform(0.1, 0.9, 12).astype(np.float32) if per_query else 0.35
    jv, ji = J.fused_pq_topk(
        jnp.asarray(q), jnp.asarray(ci), jnp.asarray(si), jnp.asarray(ct), jnp.asarray(st),
        jnp.asarray(cb_img), jnp.asarray(cb_txt), k=k, alpha=jnp.asarray(alpha), interpret=True, tile_n=128,
    )
    lut_i = _t(J.pq_luts(jnp.asarray(q), jnp.asarray(cb_img)).astype(jnp.float32)).to(torch.bfloat16)
    lut_t = _t(J.pq_luts(jnp.asarray(q), jnp.asarray(cb_txt)).astype(jnp.float32)).to(torch.bfloat16)
    tv, ti = T.pq_adc_topk(alpha_column(alpha, 12, "cpu"), lut_i, lut_t, _t(ci), _t(si), _t(ct), _t(st), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    assert (ti.numpy()[4] == 0).all() and (tv.numpy()[4] == _F32_MIN).all()
    # and from the embeddings, through the port's own LUTs
    fv, fi = T.fused_pq_topk(_t(q), _t(ci), _t(si), _t(ct), _t(st), _t(cb_img), _t(cb_txt), k=k, alpha=torch.tensor(alpha))
    assert fv.shape == (12, k) and fi.dtype == torch.int32


def test_zero_pad_rows_score_zero(packed):
    *_, ci, si, ct, st = packed
    _, _, cb_img, cb_txt = packed[:4]
    assert (si[-6:] == 0).all() and (st[-6:] == 0).all()
    q = _rows(3, seed=8)
    scores = T.blended_scores_pq_adc(_t(q), _t(ci), _t(si), _t(ct), _t(st), _t(cb_img), _t(cb_txt), 0.5)
    assert (scores[:, -6:] == 0).all()


def test_adc_scores_match_jax_oracle(packed):
    _, _, cb_img, cb_txt, ci, si, ct, st = packed
    q = _rows(6, seed=21)
    want = J.blended_scores_pq_adc(
        jnp.asarray(q), *map(jnp.asarray, (ci, si, ct, st, cb_img, cb_txt)), 0.6
    )
    got = T.blended_scores_pq_adc(_t(q), _t(ci), _t(si), _t(ct), _t(st), _t(cb_img), _t(cb_txt), 0.6)
    # the LUT cast may round one entry a bf16 step apart (test above)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=M * 2.0**-8)


@pytest.mark.parametrize("k", [10, 160])
def test_decode_path_matches_jax_xla(packed, k):
    """The CPU route (decode-and-matmul + segmented top-k), big k included."""
    _, _, cb_img, cb_txt, ci, si, ct, st = packed
    q = _rows(7, seed=22)
    alpha = np.linspace(0.1, 0.9, 7).astype(np.float32)
    jv, ji = J.pq_similarity_topk_xla(
        jnp.asarray(q), ci, si, ct, st, jnp.asarray(cb_img), jnp.asarray(cb_txt), k, jnp.asarray(alpha), 128
    )
    tv, ti = T.pq_similarity_topk(_t(q), _t(ci), _t(si), _t(ct), _t(st), _t(cb_img), _t(cb_txt), k,
                                  torch.tensor(alpha), chunk=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    dec = T.decode_pq(_t(ci), _t(si), _t(cb_img))
    np.testing.assert_allclose(dec.numpy(), np.asarray(J.decode_pq(ci, si, jnp.asarray(cb_img))), rtol=1e-6, atol=1e-7)


def test_big_k_adc_route_matches_oracle(packed):
    _, _, cb_img, cb_txt, ci, si, ct, st = packed
    q = _rows(6, seed=23)
    tv, ti = T.pq_similarity_topk_adc(_t(q), _t(ci), _t(si), _t(ct), _t(st), _t(cb_img), _t(cb_txt), 160, 0.5)
    jv, ji = J.pq_similarity_topk_adc(jnp.asarray(q), *map(jnp.asarray, (ci, si, ct, st, cb_img, cb_txt)), k=160, alpha=0.5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=M * 2.0**-8)
    with pytest.raises(ValueError, match="caps k"):
        T.fused_pq_topk(_t(q), _t(ci), _t(si), _t(ct), _t(st), _t(cb_img), _t(cb_txt), k=129)
