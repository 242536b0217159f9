"""The port's multi-host serving (``retrieval.multihost``), held to the JAX package.

In one process (no ``torch.distributed``: the broadcast is a copy) the
facade contracts of JAX ``tests/test_multihost_facade.py``: blocked routes
fail when called, not when looked up, with ``ValueError``; the collective
batch routes are blocked; concurrent coordinator searches serialize and
equal the plain retriever; ``stop`` is idempotent; a stalled work item
turns ``health()`` false; a per-call ``top_k`` is refused.

Across two processes: a torch-only worker (``tests/mp_torch_serve_worker.py``)
runs twice over gloo, the int8 corpus sharded eight ways across the process
boundary, through ``MultiHostSearch`` and then ``cli.serve --multihost``;
rank 0's answers must equal the JAX package's single-host retriever's,
computed here on the same store and weights (rows equal, scores within
1e-5; the CLI's text query within 1e-4, near ties excepted).
"""

import gzip
import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.data.tokenizer import CLIPTokenizer as JTok
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval import CLIPRetrieval as JRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval import EmbeddingStore as JStore
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.multihost import MultiHostRetrieval as JFacade
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval as TRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore as TStore
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.multihost import MultiHostRetrieval, MultiHostSearch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_ROOT, "tests", "mp_torch_serve_worker.py")
MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]
JARCH = JM.CLIPArch(16, 32, 1, 32, 16, 16, 49408, 32, 2, 1, vision_heads=2)
TARCH = TM.CLIPArch(16, 32, 1, 32, 16, 16, 49408, 32, 2, 1, vision_heads=2)


def _normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def world():
    model = JM.CLIP(JARCH, dtype=jnp.float32)
    params = JM.init_params(model, jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    image, text = _normed(rng, 48, 16), _normed(rng, 48, 16)
    uuids = [f"u{i}" for i in range(48)]
    return model, params, (image, text, uuids), _normed(rng, 5, 16)


@pytest.fixture(scope="module")
def facade_world(world):
    _, params, (image, text, uuids), _ = world
    tower = load_openai_state_dict(flax_to_openai(params), dtype=torch.float32, arch=TARCH)
    store = TStore(image, text, uuids)
    inner = TRetrieval(tower, TTok(MERGES), store, device="cpu", top_k=5, use_fused_encoder=False)
    return MultiHostRetrieval(MultiHostSearch(inner, batch=8)), inner, store


def test_blocked_routes_fail_at_call_not_access(facade_world):
    facade, _, _ = facade_world
    assert MultiHostRetrieval._BLOCKED == JFacade._BLOCKED
    for name in MultiHostRetrieval._BLOCKED:
        fn = getattr(facade, name)  # must not raise
        assert callable(fn)
        with pytest.raises(ValueError, match="multi-host"):
            fn()


def test_collective_batch_routes_blocked():
    assert "retrieval_batches" in MultiHostRetrieval._BLOCKED
    assert "retrieval_fused_batch" in MultiHostRetrieval._BLOCKED


def test_facade_matches_inner_and_serializes_threads(facade_world):
    facade, inner, store = facade_world
    q = store.image[:12]
    want = inner.retrieval_embeddings_batch(q, alpha=0.7)
    results = [None, None]

    def run(slot):
        results[slot] = facade.retrieval_embeddings_batch(q, alpha=0.7)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for got in results:
        assert [[r["uuid"] for r in row] for row in got] == [[r["uuid"] for r in row] for row in want]
        np.testing.assert_allclose([r["score"] for row in got for r in row],
                                   [r["score"] for row in want for r in row], rtol=0, atol=0)
    # text and image routes go through the same lockstep step
    assert [x["uuid"] for x in facade.retrieval("hello cat")] == [x["uuid"] for x in inner.retrieval("hello cat")]
    px = np.zeros((TARCH.image_resolution, TARCH.image_resolution, 3), np.float32)
    assert [x["uuid"] for x in facade.retrieval_image(px)] == [x["uuid"] for x in inner.retrieval_image(px)]


def test_stop_idempotent_then_search_raises(facade_world):
    _, inner, store = facade_world
    f = MultiHostRetrieval(MultiHostSearch(inner, batch=4))
    f.stop()
    f.stop()  # idempotent
    with pytest.raises(RuntimeError, match="stopped"):
        f.retrieval_embeddings_batch(store.image[:2])


def test_stall_detection_health(facade_world):
    _, inner, store = facade_world
    mh = MultiHostSearch(inner, batch=4, stall_timeout_s=0.05)
    assert mh.health()["ok"] and not mh.stalled
    release = threading.Event()
    orig_run = mh._run

    def slow_run(payload):
        release.wait(timeout=30)
        return orig_run(payload)

    mh._run = slow_run
    t = threading.Thread(target=lambda: mh.search_embeddings(store.image[:2]), daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while not mh.stalled and time.monotonic() < deadline:
        time.sleep(0.01)
    h = mh.health()
    assert mh.stalled and h["ok"] is False
    assert h["multihost"]["inflight_s"] is not None
    release.set()
    t.join(timeout=30)
    assert not t.is_alive()
    assert mh.health()["ok"] and mh._work_items == 1


def test_top_k_override_rejected(facade_world):
    facade, _, _ = facade_world
    with pytest.raises(ValueError, match="fixed-k"):
        facade.retrieval_batch(["hello"], top_k=9)
    with pytest.raises(ValueError, match="batch must be >= 1"):
        MultiHostSearch(facade._inner, batch=0)
    with pytest.raises(ValueError, match=r"queries must be \[Q, 16\]"):
        facade.retrieval_embeddings_batch(np.zeros((2, 8), np.float32))


def test_follower_api_is_not_the_coordinators(facade_world):
    _, inner, _ = facade_world
    mh = MultiHostSearch(inner, batch=2)
    with pytest.raises(RuntimeError, match="serve\\(\\) is for followers"):
        mh.serve()
    mh._proc = 1  # what a follower sees
    with pytest.raises(RuntimeError, match="coordinator-only"):
        mh.search_embeddings(np.zeros((1, 16), np.float32))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_serving_matches_jax_single_host(world, tmp_path):
    model, params, (image, text, uuids), q = world
    np.savez(tmp_path / "weights.npz", **flax_to_openai(params))
    TStore(image, text, uuids).save(str(tmp_path / "store.npz"))
    np.save(tmp_path / "q.npy", q)
    with gzip.open(tmp_path / "bpe.txt.gz", "wt", encoding="utf-8") as f:
        f.write("#version\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    port = str(_free_port())
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("SPARQL_ENDPOINT", "MISTRAL_API_KEY", "MISTRAL_AGENT_ID", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                "LOCAL_WORLD_SIZE", "KEMR_NUM_PROCESSES"):
        env.pop(var, None)
    env["CUDA_VISIBLE_DEVICES"] = ""  # the CPU mesh, gloo
    # worker output goes to files, not pipes: the two workers are coupled by
    # collectives, and one blocked on a full pipe would hold up the other
    logs = [open(tmp_path / f"p{r}.log", "w+") for r in range(2)]
    procs = []
    try:
        procs = [subprocess.Popen([sys.executable, _WORKER, str(r), "2", port, str(tmp_path)], env=env,
                                  stdout=log, stderr=subprocess.STDOUT, text=True) for r, log in enumerate(logs)]
        for p in procs:
            p.wait(timeout=60)
    finally:
        for p in procs:  # never leave collective-blocked orphans behind
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-4000:]}"
    r0, r1 = (json.loads((tmp_path / f"serve_p{r}.json").read_text()) for r in range(2))
    assert r0["world"] == r1["world"] == 2 and r0["backend"] == r1["backend"] == "gloo"
    assert r0["shards"] == [0, 1, 2, 3] and r1["shards"] == [4, 5, 6, 7]
    assert r1["served"] == 2  # 5 queries in blocks of 4

    store = JStore(image, text, uuids)
    ref = JRetrieval(model, params, JTok(MERGES), store, top_k=8, quantize_corpus=True, use_fused_encoder=False)
    want = ref.retrieval_embeddings_batch(q, alpha=0.6)
    assert r0["got"] == [[x["uuid"] for x in row] for row in want]
    np.testing.assert_allclose(np.array(r0["got_scores"]), [[x["score"] for x in row] for row in want],
                               rtol=1e-5, atol=1e-5)

    ref2 = JRetrieval(model, params, JTok(MERGES), store, quantize_corpus=True, use_fused_encoder=False)
    want2 = ref2.retrieval("hello cat", alpha=0.5)[: len(r0["cli_got"])]
    assert len(r0["cli_got"]) == 20
    scores = {x["uuid"]: x["score"] for x in ref2.retrieval("hello cat", alpha=0.5)}
    for got, w in zip(r0["cli_got"], want2):
        assert got == w["uuid"] or abs(scores[got] - w["score"]) <= 1e-4, (got, w)
