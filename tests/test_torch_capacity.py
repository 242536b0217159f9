"""The port's compressed-corpus serving slice end to end, held to the JAX package.

Each tier of the capacity ladder (int4, pq, pq + OPQ, binary + rotation +
rerank, int8 + Matryoshka truncation + rerank, IVF over int8 / int4 / pq
lists) serves the same ``.npz`` store with the same seeded weights in the
JAX ``CLIPRetrieval`` and the port's, on the CPU. The IVF tiers load one
JAX-built index cache through ``ann_index_path``. From the same query
embeddings: equal uuids, scores within 1e-4 (1e-6 after the host rerank,
which is the same NumPy code on the same rows). From text queries through
``RetrievalEngine``: the encoders differ by f32 summation order, so scores
agree to 1e-4 and a near tie may swap.
"""

import gzip
import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.data.tokenizer import CLIPTokenizer as JTok
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval import ann as JA
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.clip_retrieval import CLIPRetrieval as JRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.embedding_store import EmbeddingStore as JStore
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.engine import RetrievalEngine as JEngine
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import index as index_cli
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import serve
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval as TRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore as TStore
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.engine import RetrievalEngine as TEngine


def from_flax_params(params, **kw):
    """The port's CLIP from a flax parameter tree: the JAX package's
    ``flax_to_openai`` layout handed to the port's ``load_openai_state_dict``."""
    return load_openai_state_dict(flax_to_openai(params), **kw)


MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]
ARCH = JM.CLIPArch(
    embed_dim=64, image_resolution=32, vision_layers=1, vision_width=128,
    vision_patch_size=16, context_length=77, vocab_size=49408, text_width=128,
    text_heads=2, text_layers=2,
)
N_DOCS, NLIST, NPROBE = 300, 17, 4

TIERS = {
    "int4": dict(quantize_corpus="int4"),
    "pq": dict(quantize_corpus="pq"),
    "pq_opq": dict(quantize_corpus="pq", rotate="opq", rotate_seed=2),
    "binary_rot_rerank": dict(quantize_corpus="binary", rotate=True, rerank=True, rerank_factor=4),
    "int8_trunc_rerank": dict(quantize_corpus="int8", truncate_dim=32, rerank=True, rerank_factor=2),
    "ivf_int8": dict(quantize_corpus="int8", ann="ivf"),
    "ivf_int4": dict(quantize_corpus="int4", ann="ivf"),
    "ivf_pq": dict(quantize_corpus="pq", ann="ivf"),
}


def _queries(seed, n):
    rng = np.random.default_rng(seed)
    words = ["cat", "hel", "hello", "ca", "he"]
    return [" ".join(rng.choice(words, size=rng.integers(2, 12))) for _ in range(n)]


def _norm(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    model = JM.CLIP(ARCH, dtype=jnp.float32)
    params = JM.init_params(model, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("capacity")
    path = str(root / "store.npz")
    store = JStore(
        image=_norm(rng.standard_normal((N_DOCS, ARCH.embed_dim))),
        text=_norm(rng.standard_normal((N_DOCS, ARCH.embed_dim))),
        uuids=[f"uuid-{i:06d}" for i in range(N_DOCS)],
    )
    store.save(path)
    fp = JA.corpus_fingerprint(store.image, store.text)
    caches = {}
    for mode in ("int8", "int4", "pq"):  # one JAX-built index cache per list mode
        caches[mode] = str(root / f"ivf_{mode}.npz")
        JA.save_ivf_index(caches[mode], JA.build_ivf_index(store.image, store.text, NLIST, quantize=mode), fingerprint=fp)
    return model, params, path, caches


def _pair(world, tier, top_k=10):
    model, params, path, caches = world
    kw = dict(TIERS[tier])
    if kw.get("ann"):
        kw |= dict(ann_nlist=NLIST, ann_nprobe=NPROBE, ann_index_path=caches[kw["quantize_corpus"]])
    j = JRetrieval(model, params, JTok(MERGES), JStore.load(path), top_k=top_k, use_fused_encoder=True, **kw)
    tower = from_flax_params(params, dtype=torch.float32, arch=ARCH)
    t = TRetrieval(tower, TTok(MERGES), TStore.load(path), device="cpu", top_k=top_k, **kw)
    return j, t


def _assert_same(jres, tres, atol, exact_order=True):
    """Equal uuid lists and scores within ``atol``; with ``exact_order``
    False, results within ``atol`` of each other may trade places (or the
    last slot)."""
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        np.testing.assert_allclose([x["score"] for x in b], [x["score"] for x in a], atol=atol, rtol=0)
        if exact_order:
            assert [x["uuid"] for x in b] == [x["uuid"] for x in a]
            continue
        sa, sb = {x["uuid"]: x["score"] for x in a}, {x["uuid"]: x["score"] for x in b}
        for u in sa.keys() & sb.keys():
            assert abs(sa[u] - sb[u]) <= atol, u
        last = min(a[-1]["score"], b[-1]["score"])
        for u in sa.keys() ^ sb.keys():
            assert abs(sa.get(u, sb.get(u)) - last) <= 2 * atol, u


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_tier_matches_jax(world, tier):
    j, t = _pair(world, tier)
    if TIERS[tier].get("ann"):
        # both serve the one JAX-built cache
        assert t._corpus.ivf.nlist == NLIST and t._corpus.nprobe == NPROBE
        np.testing.assert_array_equal(t._corpus.ivf.packed_rows.numpy(), np.asarray(j._corpus.ivf_arrays[4]))
    rerank = TIERS[tier].get("rerank", False)
    # the same query embeddings into both: the slice from the scan on
    q = _norm(np.random.default_rng(11).standard_normal((12, ARCH.embed_dim)))
    alpha = 0.5 if tier.startswith("binary") else list(np.linspace(0.1, 0.9, 12))
    want = j.retrieval_embeddings_batch(q, alpha=alpha)
    got = t.retrieval_embeddings_batch(q, alpha=alpha)
    _assert_same(want, got, 1e-6 if rerank else 1e-4)
    assert all(len(r) == 10 for r in got)
    if rerank:
        # reranked scores are the exact blended f32 scores of the host rows
        store = t.store
        row = {u: i for i, u in enumerate(store.uuids)}
        for qi, r in enumerate(got):
            a = alpha if np.isscalar(alpha) else alpha[qi]
            exact = [a * (store.image[row[x["uuid"]]] @ q[qi]) + (1 - a) * (store.text[row[x["uuid"]]] @ q[qi]) for x in r]
            np.testing.assert_allclose([x["score"] for x in r], exact, rtol=1e-6, atol=1e-6)
    # text queries through the engine
    qs = _queries(1, 6)
    want = JEngine(j).retrieve_text_noknowledge_batch(qs)
    got = TEngine(t).retrieve_text_noknowledge_batch(qs)
    _assert_same(want, got, 1e-4, exact_order=False)


def test_pq_aniso_and_big_k_match_jax(world):
    model, params, path, _ = world
    kw = dict(quantize_corpus="pq", pq_aniso_t=0.2, pq_m=16, top_k=150)
    j = JRetrieval(model, params, JTok(MERGES), JStore.load(path), use_fused_encoder=True, **kw)
    t = TRetrieval(from_flax_params(params, dtype=torch.float32, arch=ARCH), TTok(MERGES), TStore.load(path),
                   device="cpu", **kw)
    q = _norm(np.random.default_rng(12).standard_normal((5, ARCH.embed_dim)))
    _assert_same(j.retrieval_embeddings_batch(q), t.retrieval_embeddings_batch(q), 1e-4)


def test_calibrate_nprobe_matches_jax(world):
    j, t = _pair(world, "ivf_int8")
    q = _norm(np.random.default_rng(13).standard_normal((16, ARCH.embed_dim)))
    want = j.calibrate_nprobe(q_emb=q, target_recall=0.9, k=5)
    got = t.calibrate_nprobe(q_emb=q, target_recall=0.9, k=5)
    assert got == want
    assert t._corpus.nprobe == got["nprobe"]


def test_capacity_pads_with_rerank_match_jax(world):
    model, params, path, _ = world
    kw = dict(quantize_corpus="int4", rerank=True, capacity_multiple=64, top_k=5)
    j = JRetrieval(model, params, JTok(MERGES), JStore.load(path), use_fused_encoder=True, **kw)
    t = TRetrieval(from_flax_params(params, dtype=torch.float32, arch=ARCH), TTok(MERGES), TStore.load(path),
                   device="cpu", **kw)
    q = _norm(np.random.default_rng(14).standard_normal((4, ARCH.embed_dim)))
    _assert_same(j.retrieval_embeddings_batch(q), t.retrieval_embeddings_batch(q), 1e-6)
    vals, idx, q_back = t.search_embeddings_batch(q)
    assert idx.shape == (4, 5 * 4 + 63) and q_back.shape == (4, ARCH.embed_dim)


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(quantize_corpus="binary"), "rerank=True"),
        (dict(quantize_corpus="binary", rerank=True, ann="ivf"), "does not compose"),
        (dict(rotate=True), "packed corpus"),
        (dict(quantize_corpus="int8", rotate="opq"), "requires quantize_corpus='pq'"),
        (dict(quantize_corpus="int8", ann="ivf", truncate_dim=32), "does not compose"),
        (dict(quantize_corpus="int4", pq_aniso_t=0.2), "requires quantize_corpus='pq'"),
        (dict(truncate_dim=65), "exceeds"),
        (dict(rerank=True, rerank_factor=0), "rerank_factor"),
        (dict(ann="hnsw"), "unknown ann"),
        (dict(quantize_corpus="int2"), "unknown quantize_corpus"),
    ],
)
def test_argument_checks_match_jax(world, kwargs, match):
    model, params, path, _ = world
    with pytest.raises(ValueError, match=match):
        JRetrieval(model, params, JTok(MERGES), JStore.load(path), use_fused_encoder=True, **kwargs)
    with pytest.raises(ValueError, match=match):
        TRetrieval(from_flax_params(params, dtype=torch.float32, arch=ARCH), TTok(MERGES), TStore.load(path),
                   device="cpu", **kwargs)


def test_ivf_pq_probe_budget_refuses(world):
    _, t = _pair(world, "ivf_pq")
    t.ann_max_batch_lookups = 10.0
    with pytest.raises(ValueError, match="ann_max_batch_lookups") as err:
        t.retrieval_batch(_queries(2, 3))
    assert "TPU" not in str(err.value) and " ms" not in str(err.value)


def _cli_env(world, tmp_path, monkeypatch):
    _, params, path, _ = world
    ckpt = str(tmp_path / "openai.npz")
    np.savez(ckpt, **flax_to_openai(params))
    vocab = tmp_path / "bpe.txt.gz"
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write("#version\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    monkeypatch.setenv("CLIP_BPE_PATH", str(vocab))
    for var in ("SPARQL_ENDPOINT", "MISTRAL_API_KEY", "MISTRAL_AGENT_ID"):
        monkeypatch.delenv(var, raising=False)
    return [f"--store={path}", f"--model.checkpoint={ckpt}", "--model.dtype=float32", "--eval.encoder=fast",
            "--device=cpu", "--query=hello cat"]


def _serve(args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        serve.main(args)
    return json.loads(buf.getvalue())["results"]


def test_serve_cli_takes_the_capacity_flags(world, tmp_path, monkeypatch):
    model, params, path, _ = world
    base = _cli_env(world, tmp_path, monkeypatch)
    got = _serve(base + ["--eval.quantize_corpus=binary", "--eval.rerank=true", "--eval.rerank_factor=8",
                         "--eval.rotate=true", "--eval.rotate_mode=random", "--eval.rotate_seed=3"])
    tower = from_flax_params(params, dtype=torch.float32, arch=ARCH)
    want = TRetrieval(tower, TTok(MERGES), TStore.load(path), device="cpu", quantize_corpus="binary", rerank=True,
                      rerank_factor=8, rotate="random", rotate_seed=3).retrieval("hello cat")[:20]
    assert [x["uuid"] for x in got] == [x["uuid"] for x in want]
    # IVF from an index the port's cli.index wrote; the engine rounds nothing
    out = str(tmp_path / "ivf.npz")
    assert index_cli.main([f"--store={path}", f"--out={out}", "--eval.quantize_corpus=int4",
                           f"--eval.ann_nlist={NLIST}", "--calibrate=0.9", "--calibrate-k=5", "--device=cpu"]) == out
    got = _serve(base + ["--eval.quantize_corpus=int4", "--eval.ann=ivf", f"--eval.ann_index={out}",
                         f"--eval.ann_nlist={NLIST}", "--eval.ann_nprobe=5", "--eval.ann_max_batch_lookups=0"])
    t = TRetrieval(tower, TTok(MERGES), TStore.load(path), device="cpu", quantize_corpus="int4", ann="ivf",
                   ann_nlist=NLIST, ann_nprobe=5, ann_index_path=out)
    assert [x["uuid"] for x in got] == [x["uuid"] for x in t.retrieval("hello cat")[:20]]


def test_index_cli_output_loads_in_jax(world, tmp_path):
    _, _, path, _ = world
    out = str(tmp_path / "ivf_pq.npz")
    index_cli.main(["--store", path, "--out", out, "--eval.quantize_corpus=pq", "--eval.pq_m=16", "--device=cpu"])
    store = JStore.load(path)
    jindex = JA.load_ivf_index(out, expected_fingerprint=JA.corpus_fingerprint(store.image, store.text))
    assert jindex.mode == "pq" and jindex.packed_img.shape[-1] == 16
    assert jindex.nlist == int(np.sqrt(N_DOCS))
    with pytest.raises(ValueError, match="int8, int4, or pq"):
        index_cli.main(["--store", path, "--out", out, "--eval.quantize_corpus=binary", "--device=cpu"])


def _host(x):
    """A corpus property as host numpy (tuples element-wise; None kept)."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_host(y) for y in x)
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_same_array(got, want, name):
    if want is None or isinstance(want, tuple):
        assert type(got) is type(want), name
        for g, w in zip(got or (), want or ()):
            _assert_same_array(g, w, name)
        return
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if got.dtype != want.dtype and got.dtype.itemsize == want.dtype.itemsize and got.dtype.kind in "iu":
        got = got.view(want.dtype)  # sign words: int32 here, uint32 there
    np.testing.assert_array_equal(got.astype(np.float32) if got.dtype != want.dtype else got,
                                  want.astype(np.float32) if got.dtype != want.dtype else want, err_msg=name)


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_corpus_properties_match_jax(world, tier):
    """``corpus_img`` / ``corpus_txt`` / their scales (JAX
    ``clip_retrieval.py:827-845``) hold the rows the scan reads, equal to
    the JAX retriever's; ``ann_spill_fraction`` equals it too."""
    j, t = _pair(world, tier)
    for name in ("corpus_img", "corpus_txt", "corpus_img_scale", "corpus_txt_scale"):
        _assert_same_array(_host(getattr(t, name)), _host(getattr(j, name)), f"{tier} {name}")
    assert t.ann_spill_fraction == pytest.approx(float(j.ann_spill_fraction), abs=1e-7)
    if TIERS[tier].get("ann"):
        assert t.corpus_img is None and t.ann_spill_fraction == pytest.approx(t._corpus.ivf.spill_fraction)
    else:
        assert t.ann_spill_fraction == 0.0


def test_rerank_image_path_matches_jax(world):
    """JAX ``tests/test_rerank.py:114``: rerank serves image queries too."""
    model, params, path, _ = world
    kw = dict(top_k=5, quantize_corpus="int4", rerank=True, rerank_factor=10)
    j = JRetrieval(model, params, JTok(MERGES), JStore.load(path), use_fused_encoder=True, **kw)
    t = TRetrieval(from_flax_params(params, dtype=torch.float32, arch=ARCH), TTok(MERGES), TStore.load(path),
                   device="cpu", **kw)
    store = t.store
    out = t.retrieval_embeddings_batch(store.image[:3], alpha=1.0)
    for i, results in enumerate(out):
        assert results[0]["uuid"] == store.uuids[i] and results[0]["score"] == pytest.approx(1.0, abs=1e-5)
    img = np.random.default_rng(5).integers(0, 255, size=(32, 32, 3), dtype=np.uint8)
    got = t.retrieval_image(img)
    assert len(got) == 5
    _assert_same([j.retrieval_image(img)], [got], 1e-4, exact_order=False)
