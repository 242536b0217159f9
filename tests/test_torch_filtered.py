"""The port's filtered and candidate search, held to the JAX package.

The masked top-k (``ops.similarity.masked_similarity_topk{,_q8,_q4}`` and
``ops.pq.masked_pq_similarity_topk``) against the JAX functions on the same
inputs; the retriever's filtered, candidate, pipelined, warmup and corpus
entry points against the JAX ``CLIPRetrieval`` on the same ``.npz`` store
with the same seeded weights, on the CPU; and the engine's filtered,
constrained and streaming methods against the JAX engine. From the same
query embeddings: equal uuids, scores within 1e-4 (1e-6 after the host
rerank, which is the same NumPy code on the same rows). From text queries
the encoders differ by f32 summation order, so scores agree to 1e-4 and a
near tie may swap.
"""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu import knowledge as JK
from knowledge_enhanced_multimodal_retrieval_tpu.data.tokenizer import CLIPTokenizer as JTok
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu.ops import pq as JP
from knowledge_enhanced_multimodal_retrieval_tpu.ops import similarity as JS
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.clip_retrieval import CLIPRetrieval as JRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.embedding_store import EmbeddingStore as JStore
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.engine import RetrievalEngine as JEngine
from knowledge_enhanced_multimodal_retrieval_tpu_torch import knowledge as TK
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import pq as TP
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as TS
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval as TRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore as TStore
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.engine import RetrievalEngine as TEngine

MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]
ARCH = JM.CLIPArch(
    embed_dim=64, image_resolution=32, vision_layers=1, vision_width=128,
    vision_patch_size=16, context_length=77, vocab_size=49408, text_width=128,
    text_heads=2, text_layers=2,
)
N_DOCS, NLIST, NPROBE = 300, 17, 4
ALLOW = [f"uuid-{i:06d}" for i in range(0, N_DOCS, 7)] + ["uuid-gone"]  # 43 rows + an unknown uuid
DENY = [f"uuid-{i:06d}" for i in range(0, N_DOCS, 2)]

TIERS = {
    "exact": dict(),
    "int8": dict(quantize_corpus="int8"),
    "int4": dict(quantize_corpus="int4"),
    "pq": dict(quantize_corpus="pq"),
    "int8_rerank": dict(quantize_corpus="int8", rerank=True, rerank_factor=3),
    "int8_trunc_rerank": dict(quantize_corpus="int8", truncate_dim=32, rerank=True, rerank_factor=2),
    "int4_rotate": dict(quantize_corpus="int4", rotate=True, rotate_seed=5),
    "exact_pads": dict(capacity_multiple=64),
}


def _norm(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _queries(seed, n):
    rng = np.random.default_rng(seed)
    words = ["cat", "hel", "hello", "ca", "he"]
    return [" ".join(rng.choice(words, size=rng.integers(2, 12))) for _ in range(n)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    model = JM.CLIP(ARCH, dtype=jnp.float32)
    params = JM.init_params(model, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    path = str(tmp_path_factory.mktemp("filtered") / "store.npz")
    JStore(
        image=_norm(rng.standard_normal((N_DOCS, ARCH.embed_dim))),
        text=_norm(rng.standard_normal((N_DOCS, ARCH.embed_dim))),
        uuids=[f"uuid-{i:06d}" for i in range(N_DOCS)],
    ).save(path)
    return model, params, path


def _tower(params):
    return load_openai_state_dict(flax_to_openai(params), dtype=torch.float32, arch=ARCH)


def _pair(world, top_k=10, **kw):
    model, params, path = world
    j = JRetrieval(model, params, JTok(MERGES), JStore.load(path), top_k=top_k, use_fused_encoder=True, **kw)
    t = TRetrieval(_tower(params), TTok(MERGES), TStore.load(path), device="cpu", top_k=top_k, **kw)
    return j, t


def _assert_same(jres, tres, atol, exact_order=True):
    """Equal uuid lists and scores within ``atol``; with ``exact_order``
    False, results within ``atol`` of each other may trade places (or the
    last slot)."""
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert len(a) == len(b)
        np.testing.assert_allclose([x["score"] for x in b], [x["score"] for x in a], atol=atol, rtol=atol)
        if exact_order:
            assert [x["uuid"] for x in b] == [x["uuid"] for x in a]
            continue
        sa, sb = {x["uuid"]: x["score"] for x in a}, {x["uuid"]: x["score"] for x in b}
        for u in sa.keys() & sb.keys():
            assert abs(sa[u] - sb[u]) <= atol, u
        if a:
            last = min(a[-1]["score"], b[-1]["score"])
            for u in sa.keys() ^ sb.keys():
                assert abs(sa.get(u, sb.get(u)) - last) <= 2 * atol, u


# ---------------------------------------------------------------------------
# the masked top-k
# ---------------------------------------------------------------------------

Q, N, D, K = 6, 300, 64, 10


def _scan_inputs(mode, seed=0):
    """(jax args, port args) for one corpus mode, from the same numpy arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((Q, D)).astype(np.float32)
    img, txt = _norm(rng.standard_normal((N, D))), _norm(rng.standard_normal((N, D)))
    if mode == "exact":
        arrays = [q, img, txt]
    elif mode == "q8":
        (qi, si), (qt, st) = TS.quantize_corpus_host(img), TS.quantize_corpus_host(txt)
        arrays = [q, qi, si, qt, st]
    elif mode == "q4":
        (qi, si), (qt, st) = TS.quantize_corpus_host_q4(img), TS.quantize_corpus_host_q4(txt)
        arrays = [q, qi, si, qt, st]
    else:
        cb_i, cb_t = TP.train_pq_codebooks(img, m=8), TP.train_pq_codebooks(txt, m=8)
        (ci, si), (ct, st) = TP.pack_pq_host(img, cb_i), TP.pack_pq_host(txt, cb_t)
        arrays = [q, ci, si, ct, st, cb_i, cb_t]
    return [jnp.asarray(a) for a in arrays], [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


_MASKED = {
    "exact": (JS.masked_similarity_topk, TS.masked_similarity_topk),
    "q8": (JS.masked_similarity_topk_q8, TS.masked_similarity_topk_q8),
    "q4": (JS.masked_similarity_topk_q4, TS.masked_similarity_topk_q4),
    "pq": (JP.masked_pq_similarity_topk, TP.masked_pq_similarity_topk),
}


def _masks(kind):
    rng = np.random.default_rng(3)
    return {
        "row": rng.random(N) < 0.4,  # [N]: one filter for the batch
        "per_query": rng.random((Q, N)) < 0.3,  # [Q, N]: one filter each
        "few": np.isin(np.arange(N), [5, 77, 123]),  # fewer eligible rows than k
        "none": np.zeros(N, bool),  # every row masked
    }[kind]


@pytest.mark.parametrize("kind", ["row", "per_query", "few", "none"])
@pytest.mark.parametrize("mode", sorted(_MASKED))
def test_masked_topk_matches_jax(mode, kind):
    jfn, tfn = _MASKED[mode]
    jargs, targs = _scan_inputs(mode)
    mask = _masks(kind)
    alpha = list(np.linspace(0.2, 0.8, Q))
    jv, ji = jfn(*jargs, jnp.asarray(mask), k=K, alpha=alpha)
    tv, ti = tfn(*targs, mask, k=K, alpha=alpha)
    assert ti.dtype == torch.int32 and tuple(ti.shape) == (Q, K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=1e-5)
    # only eligible rows, and -1 exactly where no eligible row is left
    m = np.broadcast_to(mask, (Q, N))
    idx = ti.numpy()
    for row, allowed in zip(idx, m):
        live = row[row >= 0]
        assert allowed[live].all()
        assert len(live) == min(K, int(allowed.sum())) and (row[len(live):] == -1).all()


def test_masked_topk_nan_query_and_bad_mask_match_jax():
    jargs, targs = _scan_inputs("exact")
    q = targs[0].clone()
    q[2] = float("nan")
    mask = _masks("row")
    jv, ji = JS.masked_similarity_topk(jnp.asarray(q.numpy()), *jargs[1:], jnp.asarray(mask), k=K)
    tv, ti = TS.masked_similarity_topk(q, *targs[1:], mask, k=K)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (ti[2] == -1).all() and (ti[0] >= 0).all()
    np.testing.assert_allclose(tv[[0, 1, 3]].numpy(), np.asarray(jv)[[0, 1, 3]], atol=1e-5, rtol=1e-5)
    for bad in (np.ones(N - 1, bool), np.ones((Q + 1, N), bool)):
        with pytest.raises(ValueError, match="incompatible"):
            JS.masked_similarity_topk(*jargs, jnp.asarray(bad), k=K)
        with pytest.raises(ValueError, match="incompatible"):
            TS.masked_similarity_topk(*targs, bad, k=K)


# ---------------------------------------------------------------------------
# the retriever
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_filtered_retrieval_matches_jax(world, tier):
    j, t = _pair(world, **TIERS[tier])
    rerank = TIERS[tier].get("rerank", False)
    atol = 1e-6 if rerank else 1e-4
    q = _norm(np.random.default_rng(11).standard_normal((8, ARCH.embed_dim)))
    alpha = list(np.linspace(0.1, 0.9, 8))
    for allow, deny in ((ALLOW, None), (None, DENY), (ALLOW, DENY[:10])):
        want = j.retrieval_filtered_embeddings_batch(q, allow, deny, alpha=alpha)
        got = t.retrieval_filtered_embeddings_batch(q, allow, deny, alpha=alpha)
        _assert_same(want, got, atol)
        for r in got:
            assert len(r) == 10
            assert allow is None or all(x["uuid"] in ALLOW for x in r)
            assert deny is None or not any(x["uuid"] in deny for x in r)
    # fewer eligible rows than top_k: shorter lists, no pad row, no sentinel
    few = ["uuid-000003", "uuid-000150", "uuid-000299"]
    got = t.retrieval_filtered_embeddings_batch(q, few, alpha=0.5)
    _assert_same(j.retrieval_filtered_embeddings_batch(q, few, alpha=0.5), got, atol)
    assert all(sorted(x["uuid"] for x in r) == few for r in got)
    # text queries through the encoders
    qs = _queries(1, 5)
    _assert_same(j.retrieval_filtered_batch(qs, ALLOW, alpha=0.3), t.retrieval_filtered_batch(qs, ALLOW, alpha=0.3),
                 1e-4, exact_order=False)
    _assert_same([j.retrieval_filtered(qs[0], None, DENY, top_k=4)], [t.retrieval_filtered(qs[0], None, DENY, top_k=4)],
                 1e-4, exact_order=False)
    raw = t.search_filtered_batch(qs, ALLOW, alpha=0.5)
    assert len(raw) == (3 if rerank else 2) and raw[1].shape[0] == len(qs)


def test_filtered_retrieval_int8_encoder_matches_jax(world):
    j, t = _pair(world, quantize="int8", quantize_corpus="int8")
    q = _norm(np.random.default_rng(12).standard_normal((8, ARCH.embed_dim)))
    _assert_same(j.retrieval_filtered_embeddings_batch(q, ALLOW, DENY, alpha=0.7),
                 t.retrieval_filtered_embeddings_batch(q, ALLOW, DENY, alpha=0.7), 1e-4)


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(quantize_corpus="int8", ann="ivf", ann_nlist=NLIST), "exact corpus scan"),
        (dict(quantize_corpus="binary", rerank=True), "binary-sketch"),
    ],
    ids=["ivf", "binary"],
)
def test_filtered_refusals_match_jax(world, kw, match):
    j, t = _pair(world, **kw)
    q = _norm(np.random.default_rng(13).standard_normal((2, ARCH.embed_dim)))
    messages = []
    for r in (j, t):
        with pytest.raises(ValueError, match=match) as err:
            r.retrieval_filtered_batch(["hello cat"], ALLOW)
        with pytest.raises(ValueError, match=match) as err_emb:
            r.retrieval_filtered_embeddings_batch(q, ALLOW)
        messages.append((str(err.value), str(err_emb.value)))
    assert messages[1] == messages[0]
    if not kw.get("ann"):  # the mask is built (and refused) before the binary check
        for r in (j, t):
            with pytest.raises(ValueError, match="allow_uuids and/or deny_uuids"):
                r.retrieval_filtered_embeddings_batch(q)


@pytest.mark.parametrize(
    "tier", ["exact", "int8", "int4", "pq", "int8_trunc_rerank", "binary", "ivf_int8", "ivf_pq"]
)
def test_candidates_match_jax(world, tier):
    kw = {"binary": dict(quantize_corpus="binary", rerank=True),
          "ivf_int8": dict(quantize_corpus="int8", ann="ivf", ann_nlist=NLIST, ann_nprobe=NPROBE),
          "ivf_pq": dict(quantize_corpus="pq", ann="ivf", ann_nlist=NLIST, ann_nprobe=NPROBE)}.get(tier, TIERS.get(tier))
    j, t = _pair(world, top_k=5, **kw)
    qs = _queries(2, 4)
    cands = [ALLOW[:12], ["uuid-000001", "uuid-000001", "uuid-nope"], [], DENY[:30]]
    alpha = [0.2, 0.5, 0.8, 0.4]
    want = j.retrieval_candidates_batch(qs, cands, alpha=alpha)
    got = t.retrieval_candidates_batch(qs, cands, alpha=alpha)
    _assert_same(want, got, 1e-4, exact_order=False)
    assert [len(r) for r in got] == [5, 1, 0, 5]
    assert all(x["uuid"] in cands[0] for x in got[0])
    with pytest.raises(ValueError, match="candidate lists"):
        t.retrieval_candidates_batch(qs, cands[:2])


def test_pipelined_batches_follow_their_snapshot(world):
    _, t = _pair(world, quantize_corpus="int8", capacity_multiple=16)
    batches = [_queries(s, 3 + s) for s in range(4)]
    want = [t.retrieval_batch(b, alpha=0.4) for b in batches]
    assert list(t.retrieval_batches(batches, alpha=0.4, depth=2)) == want
    raw = list(t.search_batches_pipelined(batches, alpha=0.4, depth=3))
    for (vals, idx), b in zip(raw, batches):
        v, i = t.search_batch(b, alpha=0.4)
        assert isinstance(vals, np.ndarray) and vals.shape == (len(b), t._k_fetch(t._corpus, 10))
        np.testing.assert_array_equal(idx, i.numpy())
        np.testing.assert_array_equal(vals, v.numpy())
    # a corpus update between batches: each batch maps through the corpus it
    # was searched on, the first one (searched before the update) included
    new = _norm(np.random.default_rng(5).standard_normal((2, ARCH.embed_dim)))
    q_new = t.encode_queries(["hello cat"]).numpy()

    def feed():
        yield batches[0]
        t.add_documents(np.concatenate([q_new, new[:1]]), np.concatenate([q_new, new[1:]]), ["new-a", "new-b"])
        yield ["hello cat"]

    first, second = t.retrieval_batches(feed(), alpha=0.4, depth=2)
    assert first == want[0]
    assert second[0][0]["uuid"] == "new-a"


def test_pipelined_batches_match_jax(world):
    j, t = _pair(world, quantize_corpus="int4")
    batches = [_queries(s, 4) for s in range(3)]
    want = list(JEngine(j).retrieve_text_noknowledge_batches(batches, alpha_clip=0.6))
    got = list(TEngine(t).retrieve_text_noknowledge_batches(batches, alpha_clip=0.6))
    assert len(got) == len(want) == 3
    for a, b in zip(want, got):
        _assert_same(a, b, 1e-4, exact_order=False)


@pytest.mark.parametrize(
    "sizes,kw",
    [([1, 3], dict(seq_buckets=[16])), ([2], dict(seq_buckets=[16, 32, 500], image=True)), ([1], dict(image=True))],
)
def test_warmup_counts_match_jax(world, sizes, kw):
    j, t = _pair(world, quantize_corpus="int8")
    if kw.get("seq_buckets"):
        assert t.warmup(sizes, **kw) == j.warmup(sizes, **kw)
    else:  # the default buckets: 16, 32, 64, 77 (not run in JAX here: four compiles)
        assert t.warmup(sizes, **kw) == len(sizes) * (4 + 1)
    with pytest.raises(ValueError, match="warmup batch size"):
        t.warmup([0])


def test_set_store_and_save_store_round_trip(world, tmp_path):
    _, _, path = world
    _, t = _pair(world, quantize_corpus="int8", capacity_multiple=64)
    rng = np.random.default_rng(8)
    img, txt = _norm(rng.standard_normal((3, ARCH.embed_dim))), _norm(rng.standard_normal((3, ARCH.embed_dim)))
    t.add_documents(img, txt, ["a", "b", "c"])
    t.remove_documents(["uuid-000000"])
    out = str(tmp_path / "snap.npz")
    assert t.save_store(out) == N_DOCS + 2
    back = JStore.load(out)  # the JAX package reads the port's snapshot
    assert back.uuids == [f"uuid-{i:06d}" for i in range(1, N_DOCS)] + ["a", "b", "c"]
    np.testing.assert_allclose(back.image[-3:], img, atol=1e-6)
    np.testing.assert_array_equal(back.text[:-3], TStore.load(path).text[1:])
    small = TStore.load(path)
    t.set_store(TStore(image=small.image[:20], text=small.text[:20], uuids=small.uuids[:20]))
    assert len(t.store) == 64 and t.top_k == 10
    assert {x["uuid"] for x in t.retrieval("hello cat")} <= set(small.uuids[:20])


def test_mmap_load_equals_plain_load_in_both_packages(world, tmp_path):
    _, _, path = world
    for Store in (JStore, TStore):
        plain, mapped = Store.load(path), Store.load(path, mmap=True)
        assert isinstance(mapped.image, np.memmap) and not mapped.image.flags.writeable
        assert mapped.uuids == plain.uuids
        np.testing.assert_array_equal(np.asarray(mapped.image), plain.image)
        np.testing.assert_array_equal(np.asarray(mapped.text), plain.text)
    # a memory-mapped store serves (no copy warning) and snapshots its live rows
    _, params, _ = world
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # torch warns when handed a read-only array to share
        t = TRetrieval(_tower(params), TTok(MERGES), TStore.load(path, mmap=True), device="cpu", top_k=5)
    want = TRetrieval(_tower(params), TTok(MERGES), TStore.load(path), device="cpu", top_k=5).retrieval("hello cat")
    assert t.retrieval("hello cat") == want
    t.add_documents(_norm(np.ones((1, ARCH.embed_dim))), _norm(np.ones((1, ARCH.embed_dim))), ["x"])
    out = str(tmp_path / "mm_snap.npz")
    assert t.save_store(out) == N_DOCS + 1 and JStore.load(out, mmap=True).uuids[-1] == "x"
    compressed = str(tmp_path / "z.npz")
    s = TStore.load(path)
    np.savez_compressed(compressed, image=s.image, text=s.text, uuids=np.array(s.uuids, dtype=object))
    with pytest.raises(ValueError, match="compressed"):
        TStore.load(compressed, mmap=True)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _t2s(K, hits):
    doc = {
        "distinct": True,
        "variables": [{"termType": "Variable", "value": "DigitalArtefact"}],
        "branches": [{"line": {"s": "DigitalArtefact", "p": "http://crm/P1", "o": "X_1",
                               "sType": ["http://kg/DigitalArtefact"]}}],
    }
    # "nothing ..." queries get no KG hit: the constrained search falls back
    return K.Text2SparqlRetrieval(
        K.FakeLLMClient({"nothing here": "not json"}, default=json.dumps(doc)),
        K.FakeKGSparqlClient(entities={}, artefacts=[f"http://kg/artefact/{u}" for u in hits]),
    )


def test_engine_filtered_and_constrained_match_jax(world):
    j, t = _pair(world, quantize_corpus="int8", top_k=8)
    hits = ["uuid-000007", "uuid-000070", "uuid-000140", "uuid-999999"]
    je, te = JEngine(j, _t2s(JK, hits)), TEngine(t, _t2s(TK, hits))
    qs = _queries(3, 3) + ["nothing here"]
    _assert_same(je.retrieve_text_filtered_batch(qs, ALLOW, alpha_clip=[0.2, 0.4, 0.6, 0.8]),
                 te.retrieve_text_filtered_batch(qs, ALLOW, alpha_clip=[0.2, 0.4, 0.6, 0.8]), 2e-4, exact_order=False)
    _assert_same([je.retrieve_text_filtered(qs[0], None, DENY, threshold=0.0)],
                 [te.retrieve_text_filtered(qs[0], None, DENY, threshold=0.0)], 2e-4, exact_order=False)
    for fallback in (True, False):
        want = je.retrieve_text_constrained_batch(qs, alpha_clip=[0.3, 0.5, 0.7, 0.9], fallback=fallback)
        got = te.retrieve_text_constrained_batch(qs, alpha_clip=[0.3, 0.5, 0.7, 0.9], fallback=fallback)
        _assert_same(want, got, 2e-4, exact_order=False)
        assert all(x["uuid"] in hits for r in got[:3] for x in r) and len(got[0]) == 3
        assert (len(got[3]) == 8) if fallback else got[3] == []
    _assert_same([je.retrieve_text_constrained(qs[1])], [te.retrieve_text_constrained(qs[1])], 2e-4, exact_order=False)
    with pytest.raises(ValueError, match="Text2SPARQL"):
        TEngine(t).retrieve_text_constrained("cat")
