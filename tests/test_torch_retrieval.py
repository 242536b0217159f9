"""The port's text-query search slice end to end, held to the JAX package.

The same seeded flax weights (carried across with ``from_flax_params``),
the same ``.npz`` store (written once, loaded by both packages) and the
same queries go through the JAX ``RetrievalEngine`` and the port's, with
the exact (f32) and the int8 encoder + int8 corpus modes, CLIP-only and
knowledge-enhanced (fake LLM + KG clients from ``knowledge/clients.py``).
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
from knowledge_enhanced_multimodal_retrieval_tpu.knowledge import FakeKGSparqlClient, FakeLLMClient, Text2SparqlRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.clip_retrieval import CLIPRetrieval as JRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.embedding_store import EmbeddingStore as JStore
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.engine import RetrievalEngine as JEngine
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import serve
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import from_flax_params
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval as TRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore as TStore
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.engine import RetrievalEngine as TEngine

MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]
ARCH = JM.CLIPArch(
    embed_dim=64, image_resolution=32, vision_layers=1, vision_width=128,
    vision_patch_size=16, context_length=77, vocab_size=49408, text_width=128,
    text_heads=2, text_layers=2,
)
N_DOCS = 300


def _queries(seed, n):
    rng = np.random.default_rng(seed)
    words = ["cat", "hel", "hello", "ca", "he"]
    return [" ".join(rng.choice(words, size=rng.integers(2, 12))) for _ in range(n)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    model = JM.CLIP(ARCH, dtype=jnp.float32)
    params = JM.init_params(model, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    path = str(tmp_path_factory.mktemp("store") / "store.npz")
    JStore(
        image=norm(rng.standard_normal((N_DOCS, ARCH.embed_dim))),
        text=norm(rng.standard_normal((N_DOCS, ARCH.embed_dim))),
        uuids=[f"uuid-{i:06d}" for i in range(N_DOCS)],
    ).save(path)
    return model, params, path


def _pair(world, *, quantize=None, quantize_corpus=False, top_k=10, capacity_multiple=1):
    model, params, path = world
    j = JRetrieval(
        model, params, JTok(MERGES), JStore.load(path), top_k=top_k, use_fused_encoder=True,
        quantize=quantize, quantize_corpus=quantize_corpus, capacity_multiple=capacity_multiple,
    )
    tower = from_flax_params(params, dtype=torch.float32, arch=ARCH)
    t = TRetrieval(
        tower, TTok(MERGES), TStore.load(path), device="cpu", top_k=top_k,
        quantize=quantize, quantize_corpus=quantize_corpus, capacity_multiple=capacity_multiple,
    )
    return j, t


def _assert_same(jres, tres, atol, exact_order=True):
    """Equal uuid lists and scores within ``atol``. With ``exact_order``
    False, two results whose scores lie within ``atol`` may trade places
    (or trade the last slot): a score moved by less than the tolerance can
    legitimately reorder a near tie."""
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


def test_tokenizers_agree():
    qs = _queries(0, 16)
    np.testing.assert_array_equal(TTok(MERGES)(qs), JTok(MERGES)(qs))


# exact: f32 everywhere, the same math in another summation order, so the
# order is identical and scores agree to 1e-4.
# int8: both run the W8A8 arithmetic, but an f32 ulp in another grouping can
# flip one int8 rounding of an activation, which moves that query's scores
# by ~1e-3 (measured up to 9e-4 here) and may swap a near tie; 3e-3 bounds it.
_MODES = {
    "exact": dict(quantize=None, quantize_corpus=False, atol=1e-4, exact_order=True),
    "int8": dict(quantize="int8", quantize_corpus="int8", atol=3e-3, exact_order=False),
}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_noknowledge_batch_matches_jax(world, mode):
    m = _MODES[mode]
    j, t = _pair(world, quantize=m["quantize"], quantize_corpus=m["quantize_corpus"])
    qs = _queries(1, 12)
    assert {j.seq_bucket(q) for q in qs} == {16, 32}  # both buckets served
    alphas = list(np.linspace(0.1, 0.9, len(qs)))  # a runtime alpha per query
    want = JEngine(j).retrieve_text_noknowledge_batch(qs, alpha_clip=alphas)
    got = TEngine(t).retrieve_text_noknowledge_batch(qs, alpha_clip=alphas)
    _assert_same(want, got, m["atol"], m["exact_order"])
    assert all(len(r) == 10 for r in got)


def _t2s(kg_uuid):
    llm_json = {
        "distinct": True,
        "variables": [{"termType": "Variable", "value": "DigitalArtefact"}],
        "branches": [{"line": {"s": "DigitalArtefact", "p": "http://crm/P1", "o": "X_1",
                               "sType": ["http://kg/DigitalArtefact"]}}],
    }
    llm = FakeLLMClient({}, default=json.dumps(llm_json))
    kg = FakeKGSparqlClient(entities={}, artefacts=[f"http://kg/artefact/{kg_uuid}"])
    return Text2SparqlRetrieval(llm, kg)


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_knowledge_enhanced_matches_jax(world, mode):
    m = _MODES[mode]
    j, t = _pair(world, quantize=m["quantize"], quantize_corpus=m["quantize_corpus"], top_k=40)
    q = "hello cat"
    base = t.retrieval(q)
    hit = base[30]["uuid"]  # a low-ranked uuid the KG promotes
    want = JEngine(j, _t2s(hit)).retrieve_text(q)
    got = TEngine(t, _t2s(hit)).retrieve_text(q)
    _assert_same([want], [got], m["atol"], m["exact_order"])
    assert got[0]["uuid"] == hit  # alpha * clip + beta lifts it to the top
    batch = TEngine(t, _t2s(hit)).retrieve_text_batch([q, "cat"])
    assert batch[0] == got


def test_capacity_pads_and_updates_match_jax(world):
    j, t = _pair(world, capacity_multiple=64, top_k=5)
    assert len(t.store) == 320 and t.store.uuids[-1].startswith("__pad_")
    qs = _queries(2, 4)
    _assert_same(j.retrieval_batch(qs), t.retrieval_batch(qs), 1e-4)
    rng = np.random.default_rng(3)
    new = rng.standard_normal((2, ARCH.embed_dim)).astype(np.float32)
    for r in (j, t):
        r.add_documents(new, new, ["new-a", "new-b"])
        r.remove_documents(["uuid-000001"])
    _assert_same(j.retrieval_batch(qs), t.retrieval_batch(qs), 1e-4)
    vals, idx = t.search_batch(qs, top_k=5)
    assert idx.shape == (4, 5 + 63)  # over-fetch past the pad rows
    assert all(not x["uuid"].startswith("__pad_") for r in t.retrieval_batch(qs) for x in r)


def test_flax_encoder_mode_matches_fused(world):
    model, params, path = world
    tower = from_flax_params(params, dtype=torch.float32, arch=ARCH)
    flax_mode = TRetrieval(tower, TTok(MERGES), TStore.load(path), device="cpu", use_fused_encoder=False)
    fused = TRetrieval(tower, TTok(MERGES), TStore.load(path), device="cpu")
    qs = _queries(4, 5)
    _assert_same(fused.retrieval_batch(qs), flax_mode.retrieval_batch(qs), 1e-4)


@pytest.mark.parametrize(
    "kwargs",
    [{"ann": "ivf"}, {"rerank": True}, {"truncate_dim": 32}, {"shard_corpus": True},
     {"quantize_corpus": "int4"}, {"quantize_corpus": "pq"}],
)
def test_out_of_slice_options_raise(world, kwargs):
    _, params, path = world
    tower = from_flax_params(params, dtype=torch.float32, arch=ARCH)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TRetrieval(tower, TTok(MERGES), TStore.load(path), device="cpu", **kwargs)


def test_store_npz_roundtrip_across_packages(world, tmp_path):
    _, _, path = world
    t = TStore.load(path)
    out = str(tmp_path / "again.npz")
    t.save(out)
    j = JStore.load(out)
    np.testing.assert_array_equal(j.image, t.image)
    assert j.uuids == t.uuids
    img, txt = t.device_arrays(torch.bfloat16, "cpu")
    assert img.dtype == torch.bfloat16 and tuple(txt.shape) == (N_DOCS, ARCH.embed_dim)


def test_serve_cli_answers_on_cpu(world, tmp_path, monkeypatch):
    _, params, path = world
    ckpt = str(tmp_path / "openai.npz")
    np.savez(ckpt, **flax_to_openai(params))
    vocab = tmp_path / "bpe.txt.gz"
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write("#version\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    monkeypatch.setenv("CLIP_BPE_PATH", str(vocab))
    for var in ("SPARQL_ENDPOINT", "MISTRAL_API_KEY", "MISTRAL_AGENT_ID"):
        monkeypatch.delenv(var, raising=False)
    buf = io.StringIO()
    args = [f"--store={path}", f"--model.checkpoint={ckpt}", "--model.dtype=float32",
            "--eval.encoder=int8", "--eval.quantize_corpus=int8", "--device=cpu", "--query=hello cat"]
    with redirect_stdout(buf):
        serve.main(args)
    out = json.loads(buf.getvalue())
    assert out["query"] == "hello cat" and len(out["results"]) == 20
    _, t = _pair(world, quantize="int8", quantize_corpus="int8", top_k=100)
    assert [x["uuid"] for x in out["results"]] == [x["uuid"] for x in t.retrieval("hello cat")[:20]]


def test_serve_cli_refuses_silent_fallbacks(world):
    _, _, path = world
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device=cpu"):
            serve.main([f"--store={path}", "--query=x"])  # default --device=cuda
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        serve.main([f"--store={path}", "--http=8080", "--device=cpu"])
