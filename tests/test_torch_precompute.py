"""The port's corpus-precompute path and image queries, held to the JAX package.

``cli.precompute.main`` runs on ``synthetic:37`` in batches of 16 (a ragged
last batch of 5) from an OpenAI-layout checkpoint of seeded flax weights;
JAX ``build_embedding_store`` encodes the same source with the same weights.
The stores must agree row by row, keep the uuid order, and the port's file
must load in the JAX package. Image queries then go through both packages'
``CLIPRetrieval.retrieval_image_batch`` / ``RetrievalEngine`` over that store.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.data.datasets import DataPipeline as JPipe
from knowledge_enhanced_multimodal_retrieval_tpu.data.datasets import make_synthetic_source as j_source
from knowledge_enhanced_multimodal_retrieval_tpu.data.tokenizer import CLIPTokenizer as JTok
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.clip_retrieval import CLIPRetrieval as JRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.embedding_store import EmbeddingStore as JStore
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.embedding_store import build_embedding_store
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.engine import RetrievalEngine as JEngine
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import precompute
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import make_synthetic_source as t_source
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval as TRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore as TStore
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.engine import RetrievalEngine as TEngine


def from_flax_params(params, **kw):
    """The port's CLIP from a flax parameter tree: the JAX package's
    ``flax_to_openai`` layout handed to the port's ``load_openai_state_dict``."""
    return load_openai_state_dict(flax_to_openai(params), **kw)


ARCH = JM.CLIPArch(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128, vision_patch_size=8,
    context_length=77, vocab_size=49408, text_width=128, text_heads=2, text_layers=2,
)
N, BATCH = 37, 16  # batches of 16, 16 and 5
MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]

# flax / fast: f32 everywhere, the same math in another summation order.
# int8: an f32 ulp in another grouping can flip an int8 rounding of an
# activation, which moves single values of a row by a few 1e-3 (measured
# 3.0e-3 once in this store); rows then still agree at the int8 cosine
# bound of tests/test_fast_encode.py:340.
_ENCODERS = {"flax": dict(atol=1e-4), "fast": dict(atol=1e-4), "int8": dict(atol=5e-3, cos=0.999)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    model = JM.CLIP(ARCH, dtype=jnp.float32)
    params = JM.init_params(model, jax.random.PRNGKey(5))
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "openai.npz")
    np.savez(ckpt, **flax_to_openai(params))
    return model, params, ckpt


def _jax_store(world, encoder):
    model, params, _ = world
    pipe = JPipe(j_source(N, image_size=32), JTok([]), image_size=32, num_workers=2)
    return build_embedding_store(
        model, params, pipe, batch_size=BATCH, use_fast=encoder != "flax",
        quantize="int8" if encoder == "int8" else None,
    )


def _precompute(world, tmp_path, encoder):
    out = str(tmp_path / f"store_{encoder}.npz")
    args = [f"--model.checkpoint={world[2]}", "--model.dtype=float32", f"--data.dataset=synthetic:{N}",
            "--data.image_size=32", "--data.num_workers=2", f"--eval.batch_size={BATCH}",
            f"--eval.encoder={encoder}", f"--out={out}", "--device=cpu"]
    assert precompute.main(args) == out
    return out


@pytest.mark.parametrize("encoder", sorted(_ENCODERS))
def test_precompute_cli_matches_jax_store(world, tmp_path, encoder):
    out = _precompute(world, tmp_path, encoder)
    want = _jax_store(world, encoder)
    got = JStore.load(out)  # the JAX package reads the port's file
    assert got.uuids == want.uuids == [f"uuid-{i:06d}" for i in range(N)]
    atol = _ENCODERS[encoder]["atol"]
    np.testing.assert_allclose(got.image, want.image, atol=atol, rtol=0)
    np.testing.assert_allclose(got.text, want.text, atol=atol, rtol=0)
    if "cos" in _ENCODERS[encoder]:
        for a, b in ((got.image, want.image), (got.text, want.text)):
            assert np.sum(a * b, axis=1).min() > _ENCODERS[encoder]["cos"]
    np.testing.assert_allclose(np.linalg.norm(got.image, axis=1), 1.0, atol=1e-5)
    assert TStore.load(out).dim == ARCH.embed_dim


def test_precompute_cli_refuses_mismatches(world, tmp_path):
    args = [f"--model.checkpoint={world[2]}", "--data.dataset=synthetic:4", f"--out={tmp_path / 's.npz'}"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device=cpu"):
            precompute.main(args)  # --device defaults to cuda and never falls back
    with pytest.raises(ValueError, match="image_size"):
        precompute.main(args + ["--device=cpu", "--data.image_size=224"])
    with pytest.raises(ValueError, match="encoder"):
        precompute.main(args + ["--device=cpu", "--data.image_size=32", "--eval.encoder=fp8"])


def _retrievers(world, store_path, *, quantize=None, quantize_corpus=False, use_fused_encoder=True):
    model, params, _ = world
    j = JRetrieval(model, params, JTok(MERGES), JStore.load(store_path), top_k=8,
                   use_fused_encoder=use_fused_encoder, quantize=quantize, quantize_corpus=quantize_corpus)
    t = TRetrieval(from_flax_params(params, dtype=torch.float32), TTok(MERGES), TStore.load(store_path),
                   device="cpu", top_k=8, use_fused_encoder=use_fused_encoder, quantize=quantize,
                   quantize_corpus=quantize_corpus)
    return j, t


def _assert_same(jres, tres, atol, exact_order=True):
    assert len(jres) == len(tres)
    for a, b in zip(jres, tres):
        np.testing.assert_allclose([x["score"] for x in b], [x["score"] for x in a], atol=atol, rtol=0)
        if exact_order:
            assert [x["uuid"] for x in b] == [x["uuid"] for x in a]
        else:  # a score moved by less than atol may reorder a near tie
            sa, sb = {x["uuid"]: x["score"] for x in a}, {x["uuid"]: x["score"] for x in b}
            for u in sa.keys() & sb.keys():
                assert abs(sa[u] - sb[u]) <= atol, u


_MODES = {
    "flax": dict(use_fused_encoder=False, atol=1e-4, exact_order=True),
    "exact": dict(atol=1e-4, exact_order=True),
    "int8": dict(quantize="int8", quantize_corpus="int8", atol=3e-3, exact_order=False),
}


@pytest.mark.parametrize("mode", sorted(_MODES))
def test_image_queries_match_jax(world, tmp_path, mode):
    m = dict(_MODES[mode])
    atol, exact_order = m.pop("atol"), m.pop("exact_order")
    store = _precompute(world, tmp_path, "flax")
    j, t = _retrievers(world, store, **m)
    src = t_source(N, image_size=32)
    images = [src[i]["image"] for i in (0, 5, 36)]  # raw HWC uint8: preprocessed by the retriever
    for alpha in (1.0, 0.3):
        want = j.retrieval_image_batch(images, alpha=alpha)
        got = t.retrieval_image_batch(images, alpha=alpha)
        _assert_same(want, got, atol, exact_order)
        assert all(len(r) == 8 for r in got)
    if mode != "int8":
        # alpha = 1: pure image-to-image, so each image finds its own row first
        assert [r[0]["uuid"] for r in t.retrieval_image_batch(images, alpha=1.0)] == [
            "uuid-000000", "uuid-000005", "uuid-000036"]
    _assert_same(JEngine(j).retrieve_image_batch(images, alpha_clip=1.0),
                 TEngine(t).retrieve_image_batch(images, alpha_clip=1.0), atol, exact_order)
    _assert_same([JEngine(j).retrieve_image(images[1])], [TEngine(t).retrieve_image(images[1])], atol, exact_order)


def test_encode_documents_and_embedding_queries_match_jax(world, tmp_path):
    store = _precompute(world, tmp_path, "fast")
    j, t = _retrievers(world, store)
    src = t_source(3, image_size=32, seed=9)
    images, texts = [src[i]["image"] for i in range(3)], [src[i]["target_text"] for i in range(3)]
    jimg, jtxt = j.encode_documents(images, texts)
    timg, ttxt = t.encode_documents(images, texts)
    np.testing.assert_allclose(timg, jimg, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ttxt, jtxt, atol=1e-4, rtol=0)
    for r in (j, t):
        r.add_documents(timg, ttxt, ["doc-a", "doc-b", "doc-c"])
    _assert_same(j.retrieval_embeddings_batch(jimg, alpha=0.7), t.retrieval_embeddings_batch(timg, alpha=0.7), 1e-4)
    vals, idx = t.search_embeddings_batch(timg, alpha=1.0, top_k=1)
    assert [t.store.uuids[i] for i in idx[:, 0].tolist()] == ["doc-a", "doc-b", "doc-c"]
    pixels = t.preprocess_images(images)
    assert pixels.shape == (3, 32, 32, 3) and np.array_equal(t.preprocess_images(list(pixels)), pixels)
