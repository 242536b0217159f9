"""Port's binary sign-sketch tier held to the JAX package: bit for bit the
packed words (uint32 there, the same bits as int32 here), the Hamming
distances and the per-tower proxy ``1 - 2 * ham / dim``; the alpha blend of
the two proxies to one f32 ulp (XLA may fuse its multiply-add), with equal
rows (tied proxies blend to equal values either way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.ops import binary_sketch as J
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import binary_sketch as T


def _rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("d", [64, 40, 96])
def test_pack_sign_bits_bit_equal(rng, d):
    emb = _rows(rng, 50, d)
    emb[3] = 0.0  # a pad row packs to zero words
    host = T.pack_sign_bits_host(emb)
    np.testing.assert_array_equal(host, np.asarray(J.pack_sign_bits_host(emb)))
    np.testing.assert_array_equal(host, np.asarray(J.pack_sign_bits(jnp.asarray(emb))))
    dev = T.pack_sign_bits(torch.tensor(emb))
    assert dev.dtype == torch.int32
    np.testing.assert_array_equal(dev.numpy().view(np.uint32), host)
    assert (host[3] == 0).all()


def test_popcount_covers_every_bit_pattern(rng):
    words = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    got = T.popcount32(torch.from_numpy(words.view(np.int32))).numpy()
    want = np.array([bin(int(w)).count("1") for w in words])
    np.testing.assert_array_equal(got, want)


def test_hamming_scores_bit_equal(rng):
    qb = T.pack_sign_bits_host(_rows(rng, 7, 64))
    cb = T.pack_sign_bits_host(_rows(rng, 300, 64))
    want = np.asarray(J.hamming_scores(jnp.asarray(qb), jnp.asarray(cb), chunk=128))
    got = T.hamming_scores(torch.from_numpy(qb.view(np.int32)), torch.from_numpy(cb.view(np.int32)), chunk=128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("k", [5, 40])
def test_hamming_topk_bit_equal(rng, per_query, k):
    q, img, txt = _rows(rng, 9, 64), _rows(rng, 500, 64), _rows(rng, 500, 64)
    img[-8:] = 0.0
    txt[-8:] = 0.0
    alpha = rng.uniform(0.1, 0.9, 9).astype(np.float32) if per_query else 0.5
    ib, tb = T.pack_sign_bits_host(img), T.pack_sign_bits_host(txt)
    jv, ji = J.hamming_topk(jnp.asarray(q), jnp.asarray(ib), jnp.asarray(tb), dim=64, k=k, alpha=jnp.asarray(alpha))
    tv, ti = T.hamming_topk(
        torch.tensor(q), torch.from_numpy(ib.view(np.int32)), torch.from_numpy(tb.view(np.int32)),
        dim=64, k=k, alpha=torch.tensor(alpha),
    )
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2.0**-23, atol=0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # each tower's proxy alone: alpha 1 is the image proxy, bit for bit
    jv, _ = J.hamming_topk(jnp.asarray(q), jnp.asarray(ib), jnp.asarray(tb), dim=64, k=k, alpha=1.0)
    tv, _ = T.hamming_topk(torch.tensor(q), torch.from_numpy(ib.view(np.int32)), torch.from_numpy(tb.view(np.int32)),
                           dim=64, k=k, alpha=1.0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
