"""The search pipeline's hand-off to the host, held to the finish it replaced.

``retrieval_batches`` and ``search_batches_pipelined`` queue a batch's copies
to the host when the batch is dispatched (``clip_retrieval._Fetch``) and
read them at its finish. Here, on the CPU, every batch they give is held bit
for bit to the same search finished the way it was before: the winners
fetched with ``.cpu()`` right before the uuid mapping (or the f32 host
rerank), through the corpus snapshot the batch was searched on. The card's
half of the contract (no wait at dispatch) is ``tests/test_torch_cuda.py``'s.
"""

import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops.similarity import rerank_scores_host
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore

MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]
ARCH = TM.CLIPArch(embed_dim=32, image_resolution=32, vision_layers=1, vision_width=64, vision_patch_size=16,
                   context_length=77, vocab_size=49408, text_width=64, text_heads=2, text_layers=2, vision_heads=2)
TIERS = {
    "exact": dict(quantize_corpus=False),
    "int8": dict(quantize_corpus="int8"),
    "int8_rerank": dict(quantize_corpus="int8", rerank=True, rerank_factor=3),
}
WORDS = ["cat", "hello", "he", "ca", "hel", "cat he", "hello cat"]
Q = 3  # queries a batch: one per-query alpha fits every batch
ALPHAS = {"scalar": 0.4, "per_query": np.array([0.1, 0.5, 0.9], np.float32)}


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _retriever(tier):
    rng = np.random.default_rng(3)
    n = 200
    store = EmbeddingStore(image=_unit(rng.standard_normal((n, ARCH.embed_dim))),
                           text=_unit(rng.standard_normal((n, ARCH.embed_dim))), uuids=[f"u{i}" for i in range(n)])
    torch.manual_seed(0)
    model = TM.build_model("tiny", dtype=torch.float32, seed=1, arch=ARCH)
    return CLIPRetrieval(model, CLIPTokenizer(MERGES), store, device="cpu", top_k=5, use_fused_encoder=True,
                         quantize="int8", capacity_multiple=64, **TIERS[tier])


def _batches(n):
    rng = np.random.default_rng(7)
    return [[" ".join(rng.choice(WORDS, size=int(rng.integers(1, 4)))) for _ in range(Q)] for _ in range(n)]


def _finished_as_before(t, queries, alpha):
    """One batch searched on the current corpus and finished as before the
    hand-off: ``.cpu()`` copies, then the rerank or the uuid mapping."""
    c = t._corpus
    out = t._search_state(c, queries, alpha, None)
    if t.rerank:
        _, idx, q = out
        vals, idx = rerank_scores_host(q.float().cpu().numpy(), c.store.image, c.store.text, idx.cpu().numpy(),
                                       np.asarray(alpha, np.float32))
    else:
        vals, idx = out[0].float().cpu().numpy(), out[1].cpu().numpy()
    return t.results_from_topk(vals, idx, _state=c, top_k=min(c.top_k, c.n_real))


CASES = [(tier, a, depth, False) for tier in TIERS for a in ALPHAS for depth in (1, 2, 4)]
CASES += [(tier, "scalar", depth, True) for tier in TIERS for depth in (2, 4)]


@pytest.mark.parametrize("tier,alpha_kind,depth,update", CASES,
                         ids=[f"{t}-{a}-depth{d}" + ("-update" if u else "") for t, a, d, u in CASES])
def test_pipelined_batches_equal_the_finish_before_the_hand_off(tier, alpha_kind, depth, update):
    t = _retriever(tier)
    alpha = ALPHAS[alpha_kind]
    batches = _batches(6)
    cut = 2  # with update: the corpus changes after batch cut - 1 is dispatched, before it is finished
    want = [_finished_as_before(t, b, alpha) for b in (batches[:cut] if update else batches)]
    if not update:
        raw = list(t.search_batches_pipelined(batches, alpha=alpha, depth=depth))
        assert len(raw) == len(batches)
        for (vals, idx), b in zip(raw, batches):
            v, i = t.search_batch(b, alpha=alpha)[:2]
            assert isinstance(vals, np.ndarray) and isinstance(idx, np.ndarray)
            np.testing.assert_array_equal(vals, v.float().numpy())
            np.testing.assert_array_equal(idx, i.numpy())
        assert list(t.retrieval_batches(batches, alpha=alpha, depth=depth)) == want
        return
    hit = t.encode_queries(batches[cut][:1]).numpy()  # a new row that the next batch's first query finds first
    new = _unit(np.random.default_rng(5).standard_normal((1, ARCH.embed_dim)))

    def feed():
        for i, b in enumerate(batches):
            if i == cut:  # rows shift: a batch mapped through the new corpus would name other uuids
                t.remove_documents(["u0", "u1"])
                t.add_documents(np.concatenate([hit, new]), np.concatenate([hit, new]), ["new-a", "new-b"])
            yield b

    got = list(t.retrieval_batches(feed(), alpha=alpha, depth=depth))
    want += [_finished_as_before(t, b, alpha) for b in batches[cut:]]
    assert got == want
    assert all(r["uuid"] not in ("new-a", "new-b") for batch in got[:cut] for res in batch for r in res)
    assert all(r["uuid"] not in ("u0", "u1") for batch in got[cut:] for res in batch for r in res)
    assert got[cut][0][0]["uuid"] == "new-a"
