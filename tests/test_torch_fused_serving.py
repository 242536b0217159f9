"""Learned-fusion serving in the port, held to the JAX package.

``CLIPRetrieval.retrieval_fused_batch`` (stage 1: the blended top-(factor *
k) fetch through the corpus tier; stage 2: the head over the candidates'
exact f32 rows) and ``RetrievalEngine.retrieve_text_fused_batch`` run over
exact, int8 and int8 + rerank corpora beside the JAX package's, with the
same seeded CLIP weights and the same head parameters. Then the whole path:
``cli.train_fusion`` writes a head, ``cli.serve --fusion.head_params`` (and
the JAX CLI) serve it, and the HTTP daemon answers ``{"fused": true}``.
"""

import gzip
import json
import signal
import threading
import time
from urllib.request import Request, urlopen

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from knowledge_enhanced_multimodal_retrieval_tpu.cli import serve as jserve
from knowledge_enhanced_multimodal_retrieval_tpu.data.tokenizer import CLIPTokenizer as JTok
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai, save_params_npz
from knowledge_enhanced_multimodal_retrieval_tpu.models.fusion_heads import FusionModel as JFM
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.clip_retrieval import CLIPRetrieval as JRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.embedding_store import EmbeddingStore as JStore
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.engine import RetrievalEngine as JEngine
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import serve as tserve
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import train_fusion as ttrain_cli
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fusion_heads import FusionModel as TFM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval as TRetrieval
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore as TStore
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.engine import RetrievalEngine as TEngine
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train.fusion_trainer import load_fusion_head

MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]
ARCH = JM.CLIPArch(
    embed_dim=64, image_resolution=32, vision_layers=1, vision_width=128,
    vision_patch_size=16, context_length=77, vocab_size=49408, text_width=128,
    text_heads=2, text_layers=2,
)
NAME, N_DOCS = "tiny-fused", 48
QUERIES = ["hello cat", "he cat hel", "cat cat ca", "hel he"]
# the encoders sum in another order (~1e-6 on the embeddings), and the
# engine rounds to 4 decimals
TOL = 1e-4 + 1e-4
# the same head over the same candidates (tests/test_fused_serving.py:45)
HEAD_TOL = dict(rtol=2e-5, atol=1e-6)
CORPORA = {
    "exact": dict(quantize_corpus=False),
    "int8": dict(quantize_corpus="int8"),
    "int8+rerank": dict(quantize_corpus="int8", rerank=True, rerank_factor=2),
}


def _norm(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def world():
    model = JM.CLIP(ARCH, dtype=jnp.float32)
    params = JM.init_params(model, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    store = dict(image=_norm(rng.standard_normal((N_DOCS, 64))), text=_norm(rng.standard_normal((N_DOCS, 64))),
                 uuids=[f"uuid-{i:06d}" for i in range(N_DOCS)])
    tmodel = load_openai_state_dict(flax_to_openai(params), device="cpu", dtype=torch.float32)
    jf = JFM("bilinear", 64)
    hp = jf.init(jax.random.PRNGKey(2))
    tf = TFM("bilinear", 64)
    head = tf.from_flax({k: np.asarray(v) for k, v in traverse_util.flatten_dict(hp, sep="/").items()})
    return model, params, tmodel, store, (jf, hp), (tf, head)


def _pair(world, kw, top_k=5):
    model, params, tmodel, store, _, _ = world
    j = JRetrieval(model, params, JTok(MERGES), JStore(**store), top_k=top_k, use_fused_encoder=True, **kw)
    t = TRetrieval(tmodel, TTok(MERGES), TStore(**store), device="cpu", top_k=top_k, use_fused_encoder=True, **kw)
    return j, t


def _same(a, b, atol=TOL):
    assert [x["uuid"] for x in a] == [x["uuid"] for x in b]
    np.testing.assert_allclose([x["score"] for x in a], [x["score"] for x in b], atol=atol, rtol=0)


class _Hits:
    """A Text2SPARQL stand-in: every query's hits are ``uuids``."""

    def __init__(self, uuids):
        self.uuids = list(uuids)

    def retrieval(self, query):
        return self.uuids


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_retrieval_fused_batch_matches_jax(world, corpus):
    j, t = _pair(world, CORPORA[corpus])
    (jf, hp), (tf, head) = world[4], world[5]
    want = j.retrieval_fused_batch(QUERIES, jf, hp, alpha=0.3, top_k=5, factor=3)
    got = t.retrieval_fused_batch(QUERIES, tf, head, alpha=0.3, top_k=5, factor=3)
    for a, b in zip(got, want):
        assert len(a) == 5
        _same(a, b)
    _same(t.retrieval_fused(QUERIES[1], tf, head, alpha=0.3, top_k=5, factor=3), got[1])
    # stage 2 is the head over the exact f32 rows of the stage-1 candidates
    q = t.encode_queries(QUERIES).float()
    store = world[3]
    row = {u: i for i, u in enumerate(store["uuids"])}
    for qi, res in enumerate(got):
        rows = [row[x["uuid"]] for x in res]
        want_s = tf.scores(head, q[qi : qi + 1], torch.as_tensor(store["image"][rows]),
                           torch.as_tensor(store["text"][rows]))[0].detach().numpy()
        np.testing.assert_allclose([x["score"] for x in res], want_s, **HEAD_TOL)


@pytest.mark.parametrize("corpus", ["exact", "int8", "int4"])
def test_full_fetch_equals_the_heads_full_ranking(world, corpus):
    _, t = _pair(world, {"quantize_corpus": False if corpus == "exact" else corpus}, top_k=6)
    tf, head = world[5]
    store = world[3]
    got = t.retrieval_fused_batch(QUERIES, tf, head, top_k=6, factor=N_DOCS)  # fetch = the whole corpus
    q = t.encode_queries(QUERIES).float()
    full = tf.scores(head, q, torch.as_tensor(store["image"]), torch.as_tensor(store["text"])).detach().numpy()
    for qi, res in enumerate(got):
        order = np.argsort(-full[qi], kind="stable")[:6]
        assert [x["uuid"] for x in res] == [store["uuids"][r] for r in order]
        np.testing.assert_allclose([x["score"] for x in res], full[qi][order], **HEAD_TOL)


def test_engine_fused_matches_jax(world):
    j, t = _pair(world, CORPORA["int8"])
    (jf, hp), (tf, head) = world[4], world[5]
    hits = [f"uuid-{i:06d}" for i in range(0, N_DOCS, 4)]
    je, te = JEngine(j, _Hits(hits)), TEngine(t, _Hits(hits))
    with pytest.raises(ValueError, match="set_fusion_head"):
        te.retrieve_text_fused_batch(QUERIES)
    je.set_fusion_head(jf, hp, factor=4)
    te.set_fusion_head(tf, head, factor=4)
    want = je.retrieve_text_fused_batch(QUERIES, alpha=0.7, beta=0.3, alpha_clip=0.4)
    got = te.retrieve_text_fused_batch(QUERIES, alpha=0.7, beta=0.3, alpha_clip=0.4)
    for a, b in zip(got, want):
        _same(a, b)
    _same(te.retrieve_text_fused(QUERIES[0], alpha=0.7, beta=0.3, alpha_clip=0.4), got[0])
    assert any(x["uuid"] in hits for r in got for x in r)  # the bonus applied
    # per-query stage-1 blends, and the threshold
    per_query = te.retrieve_text_fused_batch(QUERIES, alpha_clip=[0.2, 0.4, 0.6, 0.8], threshold=0.2)
    want_pq = je.retrieve_text_fused_batch(QUERIES, alpha_clip=[0.2, 0.4, 0.6, 0.8], threshold=0.2)
    for a, b in zip(per_query, want_pq):
        _same(a, b)
        assert all(x["score"] >= 0.2 for x in a)


# -- the command lines -------------------------------------------------------


@pytest.fixture(scope="module")
def files(world, tmp_path_factory):
    root = tmp_path_factory.mktemp("fused")
    model, params, _, store, _, _ = world
    store_path = str(root / "store.npz")
    TStore(**store).save(store_path)
    flax_ckpt, openai_ckpt = str(root / "flax.npz"), str(root / "openai.npz")
    save_params_npz(params, flax_ckpt)
    np.savez(openai_ckpt, **flax_to_openai(params))
    vocab = root / "bpe.txt.gz"
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write("#version\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    head = str(root / "head.npz")
    report = ttrain_cli.main([
        f"--out={head}", f"--model.checkpoint={openai_ckpt}", "--model.dtype=float32",
        "--data.dataset=synthetic:16", "--data.image_size=32", "--eval.batch_size=8",
        "--train.epochs=2", "--train.batch_size=8", "--train.lr=1e-2", "--fusion.head=simple_gated",
        "--device=cpu",
    ])
    assert "FUSION_MRR" in report["fusion"] and "BASELINE_MRR" in report["baseline"]
    with open(str(root / "head.metrics.json")) as f:
        metrics = json.load(f)
    assert len(metrics["history"]["loss"]) == 2 and metrics["eval"]["fusion"] == pytest.approx(report["fusion"])
    return dict(store=store_path, flax=flax_ckpt, openai=openai_ckpt, vocab=str(vocab), head=head)


def _env(mp, files):
    mp.setenv("CLIP_BPE_PATH", files["vocab"])
    for var in ("SPARQL_ENDPOINT", "MISTRAL_API_KEY", "MISTRAL_AGENT_ID"):
        mp.delenv(var, raising=False)


def _answers(out):
    """The JSON answers a CLI printed (log lines between them skipped)."""
    dec, found, pos = json.JSONDecoder(), [], 0
    while True:
        pos = out.find("{\n", pos)
        if pos < 0:
            return found
        obj, pos = dec.raw_decode(out, pos)
        found.append(obj)


def test_cli_train_fusion_then_serve_the_head(world, files, monkeypatch, capsys):
    _env(monkeypatch, files)
    monkeypatch.setitem(JM.ARCHS, NAME, ARCH)
    fm, head = load_fusion_head(files["head"], device="cpu")
    assert fm.fusion_type == "simple_gated" and fm.embed_dim == 64
    base = [f"--store={files['store']}", f"--model.name={NAME}", "--model.dtype=float32", "--eval.encoder=fast",
            f"--fusion.head_params={files['head']}", "--fusion.factor=3"]
    tserve.main(base + [f"--model.checkpoint={files['openai']}", "--device=cpu", f"--query={QUERIES[0]}"])
    got_one = _answers(capsys.readouterr().out)
    monkeypatch.setattr("sys.stdin", __import__("io").StringIO("\n".join(QUERIES) + "\n"))
    tserve.main(base + [f"--model.checkpoint={files['openai']}", "--device=cpu", "--batch"])
    got = _answers(capsys.readouterr().out)
    jserve.main(base + [f"--model.checkpoint={files['flax']}", f"--query={QUERIES[0]}"])  # the JAX CLI serves it too
    want_one = _answers(capsys.readouterr().out)

    engine = tserve.build_engine(__import__(
        "knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config", fromlist=["x"]).config_from_argv(
        base[1:] + [f"--model.checkpoint={files['openai']}"]), files["store"], torch.device("cpu"))
    direct = engine.retrieve_text_fused_batch(QUERIES)
    assert [a["query"] for a in got] == QUERIES
    for a, d in zip(got, direct):
        assert a["results"] == d[:20]
    assert got_one[0]["results"] == direct[0][:20]
    _same(got_one[0]["results"], want_one[0]["results"])
    # without a head the answers are the linear blend's
    monkeypatch.setattr("sys.stdin", __import__("io").StringIO(QUERIES[0] + "\n"))
    tserve.main([a for a in base if "fusion" not in a] + [f"--model.checkpoint={files['openai']}",
                                                          "--device=cpu", "--batch"])
    plain = _answers(capsys.readouterr().out)
    assert plain[0]["results"] == engine.retrieve_text_noknowledge_batch([QUERIES[0]])[0][:20]


def _post(srv, body):
    host, port = srv.address
    req = Request(f"http://{host}:{port}/search", data=json.dumps(body).encode(), method="POST",
                  headers={"Content-Type": "application/json"})
    try:
        with urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except Exception as e:  # noqa: BLE001 - HTTPError carries the status
        return e.code, json.loads(e.read())


def test_http_fused_search(world, files, monkeypatch):
    _env(monkeypatch, files)
    monkeypatch.setattr(signal, "signal", lambda *a: None)  # main runs off the main thread here
    made, errors = [], []

    class Capture(tserve.RetrievalHTTPServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    monkeypatch.setattr(tserve, "RetrievalHTTPServer", Capture)
    args = [f"--store={files['store']}", f"--model.checkpoint={files['openai']}", "--model.dtype=float32",
            "--eval.encoder=fast", f"--fusion.head_params={files['head']}", "--http=0", "--device=cpu"]

    def run():
        try:
            tserve.main(args)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    deadline = time.monotonic() + 120
    while not made and not errors and time.monotonic() < deadline:
        time.sleep(0.05)
    assert made and not errors, errors
    srv = made[0]
    try:
        engine = tserve.build_engine(
            __import__("knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config", fromlist=["x"])
            .config_from_argv([a for a in args[1:] if not a.startswith(("--http", "--device", "--store"))]),
            files["store"], torch.device("cpu"))
        for q, a in ((QUERIES[0], None), (QUERIES[2], 0.8)):
            body = {"query": q, "n": 4, "fused": True, **({} if a is None else {"alpha": a})}
            status, out = _post(srv, body)
            assert status == 200, out
            want = engine.retrieve_text_fused_batch([q], alpha_clip=[0.5 if a is None else a])[0][:4]
            assert out["results"] == want
        status, _ = _post(srv, {"query": QUERIES[0], "fused": True, "allow_uuids": ["uuid-000001"]})
        assert status == 400  # fused is exclusive with filters
    finally:
        srv.request_shutdown()
        thread.join(60)
    assert not thread.is_alive() and not errors, errors
