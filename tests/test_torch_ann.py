"""Port's IVF index (retrieval/ann.py) held to the JAX package.

The index file is the state the two packages share: a JAX-built index loads
into the port (and the reverse) and both search it alike, values to rtol
1e-5 and row ids equal, in each list mode (exact, int8, int4, residual PQ).
The k-means first seed row comes from each package's own generator, so the
builds are compared given the same centroids: everything downstream of
k-means (spill packing, quantizers, residual PQ) is bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.retrieval import ann as J
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval import ann as T

N, D, NLIST = 600, 32, 12
MODES = [None, "int8", "int4", "pq"]


def _rows(seed, n=N, d=D, clusters=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)).astype(np.float32)
    x = centers[rng.integers(0, clusters, n)] + 0.3 * rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    img, txt = _rows(1), _rows(2)
    q = _rows(3, n=10)
    return img, txt, q


@pytest.fixture(scope="module")
def jax_indexes(corpus, tmp_path_factory):
    """A JAX-built index per mode, saved with its fingerprint."""
    img, txt, _ = corpus
    fp = J.corpus_fingerprint(img, txt)
    out = {}
    for mode in MODES:
        path = str(tmp_path_factory.mktemp("ivf") / f"{mode}.npz")
        index = J.build_ivf_index(img, txt, NLIST, quantize=mode, pq_m=4 if mode == "pq" else None)
        J.save_ivf_index(path, index, fingerprint=fp)
        out[mode] = (index, path)
    return out


def _np(t):
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def test_maxmin_init_matches_jax_given_the_first_row(corpus):
    img, txt, _ = corpus
    x = np.concatenate([img, txt], axis=1)
    key = jax.random.PRNGKey(4)
    first = int(jax.random.randint(key, (), 0, x.shape[0]))
    want = np.asarray(J._maxmin_init(jnp.asarray(x), NLIST, key))
    got = T._maxmin_init(torch.tensor(x), NLIST, first).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_kmeans_spherical_is_seeded_and_normalized(corpus):
    img, txt, _ = corpus
    x = torch.tensor(np.concatenate([img, txt], axis=1))
    a, b = T.kmeans_spherical(x, NLIST, seed=3), T.kmeans_spherical(x, NLIST, seed=3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(torch.linalg.vector_norm(a, dim=1).numpy(), 1.0, atol=1e-5)
    r = T.kmeans_spherical(x, NLIST, seed=3, init="random")
    assert r.shape == (NLIST, 2 * D)
    with pytest.raises(ValueError, match="nlist"):
        T.kmeans_spherical(x[:5], NLIST)


def test_pack_with_spill_bit_equal():
    rng = np.random.default_rng(0)
    pref = np.argsort(-rng.standard_normal((500, 10)), axis=1)
    pref[:300, 0] = 3  # one hot cluster: forces spills
    np.testing.assert_array_equal(T._pack_with_spill(pref, 10, 56), J._pack_with_spill(pref, 10, 56))
    with pytest.raises(ValueError, match="capacity"):
        T._pack_with_spill(pref, 10, 40)


@pytest.mark.parametrize("mode", MODES)
def test_build_matches_jax_given_the_same_centroids(corpus, monkeypatch, mode):
    img, txt, _ = corpus
    x = np.concatenate([img, txt], axis=1)
    cent = np.asarray(J.kmeans_spherical(jnp.asarray(x), NLIST, seed=0))
    monkeypatch.setattr(J, "kmeans_spherical", lambda *a, **k: jnp.asarray(cent))
    monkeypatch.setattr(T, "kmeans_spherical", lambda *a, **k: torch.tensor(cent))
    pq_m = 4 if mode == "pq" else None
    want = J.build_ivf_index(img, txt, NLIST, quantize=mode, pq_m=pq_m)
    got = T.build_ivf_index(img, txt, NLIST, quantize=mode, pq_m=pq_m)
    assert got.mode == want.mode == (mode or "exact") and got.spill_fraction == want.spill_fraction
    for f in ("centroids_img", "centroids_txt", "packed_img", "packed_txt", "packed_rows",
              "packed_img_scale", "packed_txt_scale", "cb_img", "cb_txt"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if g is not None:
            np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=f)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("nprobe", [1, 3, NLIST])
def test_search_jax_built_index_matches_jax(corpus, jax_indexes, mode, nprobe):
    img, txt, q = corpus
    index, path = jax_indexes[mode]
    got_index = T.load_ivf_index(path, expected_fingerprint=T.corpus_fingerprint(img, txt))
    assert got_index.mode == index.mode and got_index.nlist == NLIST and got_index.cap == index.cap
    alpha = np.linspace(0.2, 0.8, q.shape[0]).astype(np.float32)
    jv, ji = J.ivf_search(jnp.asarray(q), index, k=15, nprobe=nprobe, alpha=jnp.asarray(alpha))
    tv, ti = T.ivf_search(torch.tensor(q), got_index, k=15, nprobe=nprobe, alpha=torch.tensor(alpha))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


def test_search_sentinels_past_the_probed_rows(corpus, jax_indexes):
    _, _, q = corpus
    index, path = jax_indexes["int8"]
    k = index.cap * 2 + 7  # more than two probed clusters hold
    jv, ji = J.ivf_search(jnp.asarray(q), index, k=k, nprobe=2)
    tv, ti = T.ivf_search(torch.tensor(q), T.load_ivf_index(path), k=k, nprobe=2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(np.isneginf(tv.numpy()), np.isneginf(np.asarray(jv)))
    assert (ti.numpy()[:, -7:] == -1).all()


@pytest.mark.parametrize("mode", MODES)
def test_port_index_loads_in_jax(corpus, tmp_path, mode):
    img, txt, q = corpus
    index = T.build_ivf_index(img, txt, NLIST, quantize=mode, pq_m=4 if mode == "pq" else None, seed=1)
    path = str(tmp_path / "port.npz")
    T.save_ivf_index(path, index, fingerprint=T.corpus_fingerprint(img, txt))
    jindex = J.load_ivf_index(path, expected_fingerprint=J.corpus_fingerprint(img, txt))
    assert jindex.mode == index.mode
    jv, ji = J.ivf_search(jnp.asarray(q), jindex, k=10, nprobe=4, alpha=0.3)
    tv, ti = T.ivf_search(torch.tensor(q), index, k=10, nprobe=4, alpha=0.3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="fingerprint"):
        T.load_ivf_index(path, expected_fingerprint="another corpus")
    with pytest.raises(ValueError, match=".npz"):
        T.save_ivf_index(str(tmp_path / "bare"), index)


def test_fingerprint_bit_equal(corpus):
    img, txt, _ = corpus
    assert T.corpus_fingerprint(img, txt) == J.corpus_fingerprint(img, txt)
    assert T.corpus_fingerprint(img[:-1], txt[:-1]) != T.corpus_fingerprint(img, txt)


def test_calibrate_nprobe_same_report(corpus, jax_indexes):
    img, txt, q = corpus
    index, path = jax_indexes["int8"]
    want = J.calibrate_nprobe(index, q, img, txt, k=5, target_recall=0.9)
    got = T.calibrate_nprobe(T.load_ivf_index(path), q, img, txt, k=5, target_recall=0.9)
    assert got == want
    assert T.probed_fraction(T.load_ivf_index(path), 3) == J.probed_fraction(index, 3)


@pytest.mark.parametrize("mode", ["int8", "pq"])
def test_retriever_spill_fraction_matches_jax(corpus, jax_indexes, mode):
    """JAX ``tests/test_ann.py:457``: the retriever reports its index's
    spill fraction; both retrievers serving one JAX-built cache report the
    same one, and a partial probe still returns sorted results."""
    from knowledge_enhanced_multimodal_retrieval_tpu.data.tokenizer import CLIPTokenizer as JTok
    from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
    from knowledge_enhanced_multimodal_retrieval_tpu.retrieval import CLIPRetrieval as JRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu.retrieval import EmbeddingStore as JStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval as TRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore as TStore

    img, txt, q = corpus
    index, path = jax_indexes[mode]
    uuids = [f"u{i}" for i in range(N)]
    merges = [("c", "a"), ("ca", "t</w>")]
    kw = dict(top_k=10, quantize_corpus=mode, ann="ivf", ann_nlist=NLIST, ann_nprobe=2, ann_index_path=path,
              pq_m=4 if mode == "pq" else 0)
    jmodel = JM.CLIP(JM.CLIPArch(D, 32, 1, 64, 16, 16, 600, 64, 1, 1), dtype=jnp.float32)
    j = JRetrieval(jmodel, JM.init_params(jmodel, jax.random.PRNGKey(0)), JTok(merges), JStore(img, txt, uuids), **kw)
    tmodel = TM.build_model("", dtype=torch.float32, arch=TM.CLIPArch(D, 32, 1, 64, 16, 16, 600, 64, 1, 1))
    t = TRetrieval(tmodel, TTok(merges), TStore(img, txt, uuids), device="cpu", **kw)
    assert t.ann_spill_fraction == pytest.approx(index.spill_fraction) == pytest.approx(float(j.ann_spill_fraction))
    assert 0.0 <= t.ann_spill_fraction <= 1.0
    for res in t.retrieval_embeddings_batch(q[:3]):
        scores = [r["score"] for r in res]
        assert scores == sorted(scores, reverse=True) and len(res) > 0
