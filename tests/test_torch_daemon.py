"""The serving shell as a whole: the port's ``cli.serve`` daemon beside the JAX one.

Both CLIs run their ``main`` with ``--http=0`` (an ephemeral port) on a
thread, over copies of one ``.npz`` store and the same seeded weights (a
flax ``.npz`` for the JAX CLI, its OpenAI-layout export for the port's;
the port's CLI also takes the flax ``.npz`` itself),
the port with ``--device=cpu``. The same ``/search`` (per-request alpha),
filtered, candidate and ``/search_image`` requests go to both: the same
uuids and scores within 1e-4 (the encoders sum in another order, so a near
tie may swap), plus one step of the engine's rounding to 4 decimals where
the engine fuses the scores. Then ``/documents`` and ``/snapshot`` on the port's daemon,
its ``--warmup``, ``--bucket-queries`` and ``--eval.mmap_store``, and the
CLI's refusal to fall back to the CPU.
"""

import base64
import gzip
import io
import json
import signal
import threading
import time
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.cli import serve as jserve
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai, save_params_npz
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval import http_server as JH
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval.embedding_store import EmbeddingStore as JStore
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import index as index_cli
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import serve as tserve
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore as TStore

MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]
ARCH = JM.CLIPArch(
    embed_dim=64, image_resolution=32, vision_layers=1, vision_width=128,
    vision_patch_size=16, context_length=77, vocab_size=49408, text_width=128,
    text_heads=2, text_layers=2,
)
NAME, N_DOCS = "tiny-daemon", 200
QUERIES = ["hello cat", "he cat hel", "cat cat ca", "hel he"]
ALLOW = [f"uuid-{i:06d}" for i in range(0, N_DOCS, 5)]
DENY = [f"uuid-{i:06d}" for i in range(0, N_DOCS, 3)]


def _norm(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _run_daemon(module, server_home, args, mp):
    """``module.main(args)`` on a thread; returns (server, thread, errors)
    once the daemon's socket is bound. ``server_home`` is the module whose
    ``RetrievalHTTPServer`` the CLI constructs (the JAX CLI imports it
    inside ``main``)."""
    made, errors = [], []

    class Capture(server_home.RetrievalHTTPServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    mp.setattr(server_home, "RetrievalHTTPServer", Capture)

    def run():
        try:
            module.main(args)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    deadline = time.monotonic() + 300
    while not made and not errors and time.monotonic() < deadline:
        time.sleep(0.05)
    if errors:
        raise errors[0]
    assert made, "the daemon did not start"
    return made[0], thread, errors


@pytest.fixture(scope="module")
def daemons(tmp_path_factory):
    root = tmp_path_factory.mktemp("daemon")
    model = JM.CLIP(ARCH, dtype=jnp.float32)
    params = JM.init_params(model, jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    store = JStore(
        image=_norm(rng.standard_normal((N_DOCS, ARCH.embed_dim))),
        text=_norm(rng.standard_normal((N_DOCS, ARCH.embed_dim))),
        uuids=[f"uuid-{i:06d}" for i in range(N_DOCS)],
    )
    paths = {name: str(root / f"store_{name}.npz") for name in ("jax", "port")}
    for p in paths.values():
        store.save(p)
    flax_ckpt, openai_ckpt = str(root / "flax.npz"), str(root / "openai.npz")
    save_params_npz(params, flax_ckpt)
    np.savez(openai_ckpt, **flax_to_openai(params))
    vocab = root / "bpe.txt.gz"
    with gzip.open(vocab, "wt", encoding="utf-8") as f:
        f.write("#version\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")

    mp = pytest.MonkeyPatch()
    mp.setenv("CLIP_BPE_PATH", str(vocab))
    for var in ("SPARQL_ENDPOINT", "MISTRAL_API_KEY", "MISTRAL_AGENT_ID"):
        mp.delenv(var, raising=False)
    mp.setitem(JM.ARCHS, NAME, ARCH)
    mp.setattr(signal, "signal", lambda *a: None)  # main runs off the main thread here
    common = [f"--model.name={NAME}", "--model.dtype=float32", "--eval.encoder=fast", "--http=0",
              "--cache-results=16", "--fusion.alpha_clip=0.5"]
    j = _run_daemon(jserve, JH, [f"--store={paths['jax']}", f"--model.checkpoint={flax_ckpt}"]
                    + common, mp)
    t = _run_daemon(tserve, tserve,
                    [f"--store={paths['port']}", f"--model.checkpoint={openai_ckpt}", "--device=cpu",
                     "--warmup=1,2", "--bucket-queries", "--max-pending=64", "--eval.mmap_store=true"] + common, mp)
    yield {"jax": j[0], "port": t[0], "paths": paths, "flax_ckpt": flax_ckpt}
    for srv, thread, errors in (j, t):
        srv.request_shutdown()
        thread.join(60)
        assert not thread.is_alive() and not errors, errors
    mp.undo()


def _call(srv, method, path, body=None):
    host, port = srv.address
    data = None if body is None else json.dumps(body).encode()
    req = Request(f"http://{host}:{port}{path}", data=data, method=method,
                  headers={"Content-Type": "application/json"})
    try:
        with urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except HTTPError as e:
        return e.code, json.loads(e.read())


TOL = 1e-4 + 1e-4  # encoders' summation order, and the engine's 4-decimal rounding


def _same(a, b, atol=TOL):
    """Result lists of one query: equal uuids up to near ties, scores within atol."""
    assert len(a) == len(b)
    np.testing.assert_allclose([x["score"] for x in b], [x["score"] for x in a], atol=atol, rtol=0)
    sa, sb = {x["uuid"]: x["score"] for x in a}, {x["uuid"]: x["score"] for x in b}
    for u in sa.keys() & sb.keys():
        assert abs(sa[u] - sb[u]) <= atol, u
    if a:
        last = min(a[-1]["score"], b[-1]["score"])
        for u in sa.keys() ^ sb.keys():
            assert abs(sa.get(u, sb.get(u)) - last) <= 2 * atol, u


def _both(daemons, method, path, body=None):
    (cj, oj), (ct, ot) = (_call(daemons[n], method, path, body) for n in ("jax", "port"))
    assert ct == cj, (path, body, ot, oj)
    return oj, ot


def test_search_matches_jax(daemons):
    for q in QUERIES[:2]:
        oj, ot = _both(daemons, "GET", f"/search?q={q.replace(' ', '+')}&n=7&alpha=0.3")
        assert ot["query"] == oj["query"] == q and len(ot["results"]) == 7
        _same(oj["results"], ot["results"])
    oj, ot = _both(daemons, "POST", "/search", {"queries": QUERIES, "n": 5, "alpha": 0.8})
    for a, b in zip(oj["results"], ot["results"]):
        _same(a, b)
    oj, ot = _both(daemons, "POST", "/search", {"query": QUERIES[0]})
    assert len(ot["results"]) == 20
    _same(oj["results"], ot["results"])
    # errors answer alike
    for path in ("/search?q=cat&n=abc", "/search?q=cat&alpha=nan", "/search"):
        oj, ot = _both(daemons, "GET", path)
        assert ot == oj
    oj, ot = _both(daemons, "POST", "/search", {"query": "cat", "fused": True})
    assert ot == oj


def test_filtered_search_matches_jax(daemons):
    for body in ({"queries": QUERIES, "allow_uuids": ALLOW, "n": 6, "alpha": 0.6},
                 {"query": QUERIES[2], "deny_uuids": DENY, "n": 9},
                 {"query": QUERIES[3], "allow_uuids": ALLOW[:3] + ["uuid-none"], "n": 10}):
        oj, ot = _both(daemons, "POST", "/search", body)
        lists_j = oj["results"] if "queries" in body else [oj["results"]]
        lists_t = ot["results"] if "queries" in body else [ot["results"]]
        for a, b in zip(lists_j, lists_t):
            _same(a, b)
            assert all(x["uuid"] in body.get("allow_uuids", [x["uuid"]]) for x in b)
            assert not any(x["uuid"] in body.get("deny_uuids", []) for x in b)
    assert len(lists_t[0]) <= 3  # three eligible rows (and the threshold): a shorter list


def test_candidates_match_jax(daemons):
    cands = [ALLOW[:8], [DENY[4], DENY[4], "uuid-none"], [], ALLOW[8:30]]
    oj, ot = _both(daemons, "POST", "/search", {"queries": QUERIES, "candidates": cands, "n": 5, "alpha": 0.4})
    for a, b in zip(oj["results"], ot["results"]):
        _same(a, b)
    assert [len(r) for r in ot["results"]] == [5, 1, 0, 5]


def _png(seed):
    from PIL import Image

    px = np.random.default_rng(seed).integers(0, 255, (ARCH.image_resolution,) * 2 + (3,), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(px, "RGB").save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def test_image_search_matches_jax(daemons):
    oj, ot = _both(daemons, "POST", "/search_image", {"images": [_png(1), _png(2)], "n": 6})
    for a, b in zip(oj["results"], ot["results"]):
        assert len(b) == 6
        _same(a, b)
    oj, ot = _both(daemons, "POST", "/search_image", {"image": "not-base64!!!"})
    assert ot == oj


def test_port_daemon_flags(daemons):
    srv = daemons["port"]
    code, health = _call(srv, "GET", "/healthz")
    assert code == 200 and health["ok"] and health["stats"]["served"] > 0
    assert srv.batcher._bucket_fn is not None  # --bucket-queries
    assert srv.batcher._max_pending == 64
    # the same query twice: the second is served from the result cache
    served = srv.batcher.stats["served"]
    assert _call(srv, "GET", "/search?q=cat+hel")[1] == _call(srv, "GET", "/search?q=cat+hel")[1]
    assert srv.batcher.stats["served"] == served + 1
    assert "kemr_requests_served_total" in urlopen("http://{}:{}/metrics".format(*srv.address), timeout=30).read().decode()


def test_documents_and_snapshot(daemons):
    srv, path = daemons["port"], daemons["paths"]["port"]
    rng = np.random.default_rng(21)
    doc_img, doc_txt = _norm(rng.standard_normal((2, ARCH.embed_dim)))
    code, out = _call(srv, "POST", "/documents", {"documents": [
        {"uuid": "new-doc", "image_embedding": doc_img.tolist(), "text_embedding": doc_txt.tolist()}]})
    assert code == 200 and out == {"added": 1}
    # candidate scoring sees the new row (a filtered search would drop it
    # under the fusion threshold if its random rows scored below 0)
    code, out = _call(srv, "POST", "/search", {"queries": ["cat"], "candidates": [["new-doc", "uuid-000001"]]})
    assert sorted(x["uuid"] for x in out["results"][0]) == ["new-doc", "uuid-000001"]
    code, out = _call(srv, "POST", "/documents", {"documents": [
        {"uuid": "new-doc", "image_embedding": doc_img.tolist(), "text_embedding": doc_txt.tolist()}]})
    assert code == 409
    # raw documents are encoded by the daemon's own towers
    code, out = _call(srv, "POST", "/documents", {"documents": [{"uuid": "raw-doc", "image": _png(3),
                                                                 "text": "hello cat"}]})
    assert code == 200 and out == {"added": 1}
    code, out = _call(srv, "POST", "/snapshot", {})
    assert code == 200 and out == {"saved": True, "path": path, "rows": N_DOCS + 2}
    back = JStore.load(path)  # the JAX package reads the port's snapshot
    assert back.uuids[-2:] == ["new-doc", "raw-doc"]
    np.testing.assert_allclose(back.image[-2], doc_img, atol=1e-6)
    code, out = _call(srv, "DELETE", "/documents", {"uuids": ["new-doc", "raw-doc"]})
    assert code == 200 and out == {"removed": 2}
    code, out = _call(srv, "POST", "/search", {"queries": ["cat"], "candidates": [["new-doc", "raw-doc"]]})
    assert code == 200 and out["results"] == [[]]
    assert _call(srv, "DELETE", "/documents", {"uuids": ["new-doc"]})[0] == 404


def test_cli_flags_without_a_card(tmp_path):
    store = str(tmp_path / "s.npz")
    TStore(image=_norm(np.ones((4, 8))), text=_norm(np.ones((4, 8))), uuids=list("abcd")).save(store)
    if not torch.cuda.is_available():
        for main, args in ((tserve.main, [f"--store={store}", "--http=0"]),
                           (index_cli.main, ["--store", store, "--out", str(tmp_path / "i.npz")])):
            with pytest.raises(RuntimeError, match="--device=cpu"):
                main(args)  # the default device is the card
    # multi-host serving is ported; --warmup would search outside the broadcast, as in JAX
    with pytest.raises(ValueError, match="--warmup does not compose with --multihost"):
        tserve.main([f"--store={store}", "--multihost", "--warmup=1,2", "--device=cpu"])
    opts = tserve.pop_daemon_flags(args := ["--http", "8080", "--warmup=1,2", "--bucket-queries", "--x=1"])
    assert args == ["--x=1"] and opts == tserve.DaemonOptions(port=8080, warmup="1,2", bucket_queries=True)
    out = index_cli.main(["--store", store, "--out", str(tmp_path / "ivf.npz"), "--eval.ann_nlist=2",
                          "--eval.mmap_store=true", "--device=cpu"])
    assert out.endswith("ivf.npz")


def test_daemon_bench_quick_on_cpu(tmp_path):
    """The port's daemon benchmark at its tiny size: every request answered,
    the JAX record's fields, written where ``--out`` says and never over the
    JAX package's ``DAEMON_BENCH.json``."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import daemon_bench

    out = tmp_path / "bench.json"
    result = daemon_bench.main(["--quick", "--device=cpu", f"--out={out}"])
    assert json.loads(out.read_text()) == json.loads(json.dumps(result))
    assert set(result) == {"metric", "value", "unit", "detail"} and result["value"] > 0
    d = result["detail"]
    assert d["error_count"] == 0 and d["requests_total"] == 48 and d["backend"] == "cpu"
    assert d["text"]["n"] + d["image"].get("n", 0) == 48 and d["text"]["p50_ms"] <= d["text"]["p99_ms"]
    assert sum(n * c for n, c in d["text_batcher"]["batch_size_hist"].items()) == d["text"]["n"]
    with pytest.raises(ValueError, match="DAEMON_BENCH.json"):
        daemon_bench.main(["--quick", "--device=cpu", f"--out={daemon_bench.REPO}/DAEMON_BENCH.json"])


def test_port_cli_takes_the_jax_clis_flax_npz(daemons, tmp_path):
    """The one flax ``.npz`` the JAX daemon loaded also serves the port's
    CLI (``--model.checkpoint``): its answers equal the JAX daemon's."""
    import contextlib

    store = str(tmp_path / "store.npz")
    TStore.load(daemons["paths"]["jax"]).save(store)
    for q in QUERIES[:2]:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tserve.main([f"--store={store}", f"--model.checkpoint={daemons['flax_ckpt']}", "--model.dtype=float32",
                         "--eval.encoder=fast", "--fusion.alpha_clip=0.5", "--device=cpu", f"--query={q}"])
        got = json.loads(buf.getvalue())["results"]
        code, want = _call(daemons["jax"], "GET", f"/search?q={q.replace(' ', '+')}&n={len(got)}")
        assert code == 200 and len(got) > 0
        _same(want["results"], got)
