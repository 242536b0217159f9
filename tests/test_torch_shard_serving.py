"""The port's sharded serving modes, held to the JAX retriever on the CPU.

``CLIPRetrieval(rt=..., shard_corpus=True)`` and ``(..., shard_queries=True)``
over ``[cpu] * n`` against the JAX retriever with the same flags over the
conftest's first ``n`` virtual devices, with the same seeded weights
(``flax_to_openai`` -> ``load_openai_state_dict``) and the same ``.npz``
store: every corpus tier, every route (embeddings, text, images, filtered,
candidates, the pipelined stream, raw winners), corpus updates that restage
the shards, and the refusals. Both packages use the module towers, so text
queries agree to 1e-4 (f32 summation order) and a near tie may swap; from
the same embeddings the rows are equal and scores agree to 1e-4. The IVF
tier serves one index file that the JAX retriever wrote (the packages'
k-means draw other seeds). Alphas are quarters, so the sketch proxies are
exact in both packages and their ties order alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.data.tokenizer import CLIPTokenizer as JTok
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import MeshRuntime as JMeshRuntime
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.clip_retrieval import CLIPRetrieval as JRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.embedding_store import EmbeddingStore as JStore
from knowledge_enhanced_multimodal_retrieval_tpu.utils.config import MeshConfig as JMeshConfig
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import MeshRuntime as TMeshRuntime
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import RowShards
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval as TRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore as TStore
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig as TMeshConfig

MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]
ARCH = JM.CLIPArch(
    embed_dim=64, image_resolution=32, vision_layers=1, vision_width=128,
    vision_patch_size=16, context_length=77, vocab_size=49408, text_width=128,
    text_heads=2, text_layers=2,
)
N_DOCS, NLIST = 301, 16  # 301 rows: the shards pad
TIERS = {
    "exact": dict(),
    "int8": dict(quantize_corpus="int8"),
    "int4": dict(quantize_corpus="int4"),
    "pq": dict(quantize_corpus="pq"),
    "binary_rerank": dict(quantize_corpus="binary", rerank=True, rerank_factor=3),
    "ivf_int8": dict(quantize_corpus="int8", ann="ivf", ann_nlist=NLIST, ann_nprobe=6),
    "int8_trunc_rerank": dict(quantize_corpus="int8", truncate_dim=32, rerank=True, rerank_factor=2),
    "int4_rotate": dict(quantize_corpus="int4", rotate=True, rotate_seed=5),
    "exact_pads": dict(capacity_multiple=16),
}
MODES = ("shard_corpus", "shard_queries")
TOL = 1e-4


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
    tmp = tmp_path_factory.mktemp("shard_serving")
    path = str(tmp / "store.npz")
    JStore(
        image=_norm(rng.standard_normal((N_DOCS, ARCH.embed_dim))),
        text=_norm(rng.standard_normal((N_DOCS, ARCH.embed_dim))),
        uuids=[f"uuid-{i:06d}" for i in range(N_DOCS)],
    ).save(path)
    tower = load_openai_state_dict(flax_to_openai(params), dtype=torch.float32, arch=ARCH)
    return model, params, tower, path, tmp


def _pair(world, devices8, n, mode, top_k=10, **kw):
    model, params, tower, path, tmp = world
    if kw.get("ann"):
        # one index file: the JAX retriever writes it, the port loads it
        kw["ann_index_path"] = str(tmp / f"ivf_{n}_{mode}.npz")
    jrt = JMeshRuntime.create(JMeshConfig(data_parallel=n), devices=devices8[:n])
    trt = TMeshRuntime.create(TMeshConfig(data_parallel=n), [torch.device("cpu")] * n)
    j = JRetrieval(model, params, JTok(MERGES), JStore.load(path), top_k=top_k, use_fused_encoder=False,
                   rt=jrt, **{mode: True}, **kw)
    t = TRetrieval(tower, TTok(MERGES), TStore.load(path), device="cpu", top_k=top_k, use_fused_encoder=False,
                   rt=trt, **{mode: True}, **kw)
    assert getattr(t, mode) and getattr(j, mode)
    return j, t


def _same(jres, tres, atol=TOL, exact_order=True):
    """Equal uuid lists and scores within ``atol``; with ``exact_order``
    False, results within ``atol`` of each other may trade places (or the
    last slot)."""
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        assert len(a) == len(b)
        np.testing.assert_allclose([x["score"] for x in b], [x["score"] for x in a], atol=atol, rtol=0)
        if exact_order:
            assert [x["uuid"] for x in b] == [x["uuid"] for x in a]
            continue
        sa, sb = {x["uuid"]: x["score"] for x in a}, {x["uuid"]: x["score"] for x in b}
        if a:
            last = min(a[-1]["score"], b[-1]["score"])
            for u in sa.keys() ^ sb.keys():
                assert abs(sa.get(u, sb.get(u)) - last) <= 2 * atol, u


def _emb(seed, n=13):  # 13 queries: a batch that pads under shard_queries
    rng = np.random.default_rng(seed)
    return _norm(rng.standard_normal((n, ARCH.embed_dim))), rng.choice([0.25, 0.5, 0.75], n).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tier_matches_jax(world, devices8, tier, mode):
    j, t = _pair(world, devices8, 4, mode, **TIERS[tier])
    q, alpha = _emb(1)
    _same(j.retrieval_embeddings_batch(q, alpha=alpha), t.retrieval_embeddings_batch(q, alpha=alpha))
    qs = _queries(2, 9)
    _same(j.retrieval_batch(qs, alpha=0.5), t.retrieval_batch(qs, alpha=0.5), exact_order=False)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tier", ["exact", "int8", "pq"])
@pytest.mark.parametrize("n", [2, 8])
def test_mesh_sizes_match_jax(world, devices8, n, tier, mode):
    j, t = _pair(world, devices8, n, mode, **TIERS[tier])
    q, alpha = _emb(3)
    _same(j.retrieval_embeddings_batch(q, alpha=alpha), t.retrieval_embeddings_batch(q, alpha=alpha))
    qs = _queries(4, 5)
    _same(j.retrieval_batch(qs, alpha=alpha[:5]), t.retrieval_batch(qs, alpha=alpha[:5]), exact_order=False)


ALLOW = [f"uuid-{i:06d}" for i in range(0, N_DOCS, 7)] + ["uuid-gone"]
DENY = [f"uuid-{i:06d}" for i in range(0, N_DOCS, 2)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tier", ["exact", "int8", "int4", "pq", "int8_trunc_rerank"])
def test_routes_match_jax(world, devices8, tier, mode):
    """Filtered, candidate, pipelined, raw-winner and image routes."""
    j, t = _pair(world, devices8, 4, mode, **TIERS[tier])
    qs = _queries(5, 6)
    q, alpha = _emb(6, 6)
    for allow, deny in ((ALLOW, None), (None, DENY), (ALLOW, DENY)):
        _same(j.retrieval_filtered_batch(qs, allow, deny, alpha=0.5), t.retrieval_filtered_batch(qs, allow, deny,
              alpha=0.5), exact_order=False)
        _same(j.retrieval_filtered_embeddings_batch(q, allow, deny, alpha=alpha),
              t.retrieval_filtered_embeddings_batch(q, allow, deny, alpha=alpha))
    assert all(x["uuid"] in ALLOW for r in t.retrieval_filtered_batch(qs, ALLOW) for x in r)
    cands = [ALLOW[:8], [DENY[4], DENY[4], "uuid-none"], [], ALLOW[8:30], DENY[:3], ALLOW]
    _same(j.retrieval_candidates_batch(qs, cands, alpha=0.5), t.retrieval_candidates_batch(qs, cands, alpha=0.5),
          exact_order=False)
    batches = [qs[:4], qs[4:], qs[1:3]]
    for a, b in zip(j.retrieval_batches(batches, alpha=0.5, depth=2), t.retrieval_batches(batches, alpha=0.5, depth=2)):
        _same(a, b, exact_order=False)
    # raw winners: global rows, the capacity over-fetch of the mesh's pads
    jv, ji = (np.asarray(x) for x in j.search_embeddings_batch(q, alpha=alpha)[:2])
    tv, ti = (x.numpy() for x in t.search_embeddings_batch(q, alpha=alpha)[:2])
    assert ti.shape == ji.shape
    np.testing.assert_allclose(tv, jv, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(ti, ji)
    # image queries: the vision tower on the whole batch, then the sharded scan
    px = np.random.default_rng(8).uniform(-1, 1, (3, ARCH.image_resolution, ARCH.image_resolution, 3)).astype(
        np.float32)
    _same(j.retrieval_image_batch(list(px), alpha=0.75), t.retrieval_image_batch(list(px), alpha=0.75),
          exact_order=False)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tier", ["exact", "int8", "binary_rerank"])
def test_updates_restage_the_shards(world, devices8, tier, mode):
    """add_documents / remove_documents rebuild the sharded (or replicated)
    corpus; the results follow JAX's through both updates."""
    j, t = _pair(world, devices8, 4, mode, **TIERS[tier])
    rng = np.random.default_rng(9)
    new_img, new_txt = _norm(rng.standard_normal((5, ARCH.embed_dim))), _norm(rng.standard_normal((5, ARCH.embed_dim)))
    new = [f"new-{i}" for i in range(5)]
    q, alpha = _emb(10, 7)
    q[:2] = new_img[:2]  # two queries find the new rows
    for r in (j, t):
        r.add_documents(new_img, new_txt, new)
    got = t.retrieval_embeddings_batch(q, alpha=alpha)
    _same(j.retrieval_embeddings_batch(q, alpha=alpha), got)
    assert got[0][0]["uuid"] == "new-0" and got[1][0]["uuid"] == "new-1"
    gone = new[:3] + ["uuid-000004"]
    for r in (j, t):
        r.remove_documents(gone)
    got = t.retrieval_embeddings_batch(q, alpha=alpha)
    _same(j.retrieval_embeddings_batch(q, alpha=alpha), got)
    assert not any(x["uuid"] in gone for r in got for x in r)
    assert len(t.store) == len(j.store) and t.store.uuids == j.store.uuids


def test_corpus_stages_as_row_views(world, devices8):
    """A mesh of one repeated device holds one staged copy: every shard is
    a row view of it, the rows pad to capacity_multiple x num_data, and the
    IVF index cuts by cluster with nlist snapped to the axis."""
    model, params, tower, path, tmp = world
    rt = TMeshRuntime.create(TMeshConfig(data_parallel=4), [torch.device("cpu")] * 4)
    t = TRetrieval(tower, TTok(MERGES), TStore.load(path), device="cpu", rt=rt, shard_corpus=True,
                   quantize_corpus="int8", capacity_multiple=8)
    assert isinstance(t.corpus_img, RowShards) and len(t.store) == 320 and t.corpus_img.shard_n == 80
    base = t.corpus_img.shards[0][1]
    for g, part in t.corpus_img.shards:
        assert part.data_ptr() == base.data_ptr() + g * 80 * base.shape[1]
    t = TRetrieval(tower, TTok(MERGES), TStore.load(path), device="cpu", rt=rt, shard_corpus=True,
                   ann="ivf", ann_nlist=9)
    assert t._corpus.ivf.nlist == 12 and [g for g, _ in t._corpus.ivf_shards.shards] == [0, 1, 2, 3]


def test_modes_off_without_a_mesh(world):
    """As in JAX: without ``rt`` both flags are off."""
    _, _, tower, path, _ = world
    t = TRetrieval(tower, TTok(MERGES), TStore.load(path), device="cpu", shard_corpus=True)
    assert not t.shard_corpus and not t.shard_queries


def test_ivf_refuses_a_corpus_too_small_to_shard(world, devices8):
    model, params, tower, _, tmp = world
    path = str(tmp / "tiny.npz")
    rng = np.random.default_rng(0)
    JStore(_norm(rng.standard_normal((3, 64))), _norm(rng.standard_normal((3, 64))), ["a", "b", "c"]).save(path)
    jrt = JMeshRuntime.create(JMeshConfig(data_parallel=4), devices=devices8[:4])
    trt = TMeshRuntime.create(TMeshConfig(data_parallel=4), [torch.device("cpu")] * 4)
    with pytest.raises(ValueError) as jerr:
        JRetrieval(model, params, JTok(MERGES), JStore.load(path), rt=jrt, shard_corpus=True, ann="ivf")
    with pytest.raises(ValueError) as terr:
        TRetrieval(tower, TTok(MERGES), TStore.load(path), device="cpu", rt=trt, shard_corpus=True, ann="ivf")
    assert str(terr.value) == str(jerr.value)


def test_dryrun_multichip_on_cpu():
    """The port's dry run over ``[cpu] * 4`` and ``* 8``: the eight training
    sections (dp, lora dp, dp x tp2, dp2 x pp2, sp4, fsdp, dcn2 x dp equal to
    flat dp, ep4), then the serving sections, each held to its one-shard
    scan; one line a section."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import dryrun_multichip

    for n in (4, 8):
        lines = dryrun_multichip.main([f"--devices={n}", "--device=cpu"])
        assert len(lines) == 14 and all(f"dryrun_multichip({n} on cpu)" in x and " ok" in x for x in lines)
        assert "(== flat dp)" in lines[6] and "query-DP" in lines[-1]
