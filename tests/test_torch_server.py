"""The port's copies of the MicroBatcher and the HTTP daemon, held to the JAX package.

Every case of the JAX package's ``tests/test_server.py`` that runs over fake
hooks runs here twice, over the JAX modules and over the port's
(``retrieval.server``, ``retrieval.http_server``); both servers then answer
one script of requests, every endpoint and every error, with the same status
codes and JSON; and the port's repair of ``MicroBatcher.stats`` (the
counters and the batch-size histogram are read under the lock) holds while
batches of new sizes dispatch.
"""

import threading
import time
import types

import numpy as np
import pytest

from knowledge_enhanced_multimodal_retrieval_tpu.retrieval import embedding_store as JES
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval import http_server as JH
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval import server as JSV
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval import embedding_store as TES
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval import http_server as TH
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval import server as TSV

PACKAGES = {
    "jax": types.SimpleNamespace(MicroBatcher=JSV.MicroBatcher, Overloaded=JSV.Overloaded,
                                 RetrievalHTTPServer=JH.RetrievalHTTPServer, DuplicateUUIDError=JES.DuplicateUUIDError),
    "port": types.SimpleNamespace(MicroBatcher=TSV.MicroBatcher, Overloaded=TSV.Overloaded,
                                  RetrievalHTTPServer=TH.RetrievalHTTPServer, DuplicateUUIDError=TES.DuplicateUUIDError),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def test_port_modules_import_the_ports_own():
    assert TH.MicroBatcher is TSV.MicroBatcher and TH.DuplicateUUIDError is TES.DuplicateUUIDError
    assert TSV.Overloaded is not JSV.Overloaded


def test_batches_aggregate_concurrent_requests(pkg):
    calls = []

    def batch_fn(queries):
        calls.append(list(queries))
        return [[{"uuid": q}] for q in queries]

    with pkg.MicroBatcher(batch_fn, max_batch=64, max_wait_ms=50.0) as mb:
        futs = [mb.submit(f"q{i}") for i in range(20)]
        results = [f.result(timeout=10) for f in futs]
    assert [r[0]["uuid"] for r in results] == [f"q{i}" for i in range(20)]
    # 20 near-simultaneous submits must NOT become 20 device calls
    assert mb.stats["served"] == 20
    assert mb.stats["batches"] == len(calls) < 20


def test_pad_to_bucket_shapes(pkg):
    """Dispatched batch sizes are powers of two (one compile per bucket on
    jit backends), results sliced back to the real request count."""
    sizes = []

    def batch_fn(queries):
        sizes.append(len(queries))
        return [[{"uuid": q}] for q in queries]

    with pkg.MicroBatcher(batch_fn, max_batch=64, max_wait_ms=40.0) as mb:
        futs = [mb.submit(f"q{i}") for i in range(11)]
        out = [f.result(timeout=10)[0]["uuid"] for f in futs]
    assert out == [f"q{i}" for i in range(11)]
    assert all(s & (s - 1) == 0 for s in sizes), sizes  # powers of two
    assert mb.stats["served"] == 11


def test_max_batch_splits(pkg):
    sizes = []

    def batch_fn(queries):
        sizes.append(len(queries))
        return [[] for _ in queries]

    with pkg.MicroBatcher(batch_fn, max_batch=4, max_wait_ms=200.0) as mb:
        futs = [mb.submit(str(i)) for i in range(10)]
        for f in futs:
            f.result(timeout=10)
    assert max(sizes) <= 4 and sum(sizes) == 10


def test_error_propagates_to_all_waiters(pkg):
    def batch_fn(queries):
        raise ValueError("backend down")

    with pkg.MicroBatcher(batch_fn, max_batch=8, max_wait_ms=20.0) as mb:
        futs = [mb.submit(str(i)) for i in range(3)]
        for f in futs:
            with pytest.raises(ValueError, match="backend down"):
                f.result(timeout=10)
    # the worker survives an erroring batch (next submit before close worked)


def test_close_rejects_new_work(pkg):
    mb = pkg.MicroBatcher(lambda qs: [[] for _ in qs])
    mb.close()
    with pytest.raises(RuntimeError):
        mb.submit("x")


def test_http_server_endpoints(pkg):
    """GET/POST /search + /healthz over a fake backend, concurrent clients."""
    import json
    from urllib.request import Request, urlopen

    def batch_fn(queries):
        return [[{"uuid": f"hit-{q}", "score": 1.0}] for q in queries]

    with pkg.RetrievalHTTPServer(batch_fn, port=0, max_wait_ms=10.0) as srv:
        host, port = srv.address
        base = f"http://{host}:{port}"
        health = json.load(urlopen(f"{base}/healthz", timeout=10))
        assert health["ok"] is True

        out = json.load(urlopen(f"{base}/search?q=vase&n=5", timeout=10))
        assert out["results"][0]["uuid"] == "hit-vase"

        req = Request(
            f"{base}/search",
            data=json.dumps({"queries": ["a", "b", "c"]}).encode(),
            headers={"Content-Type": "application/json"},
        )
        out = json.load(urlopen(req, timeout=10))
        assert [r[0]["uuid"] for r in out["results"]] == ["hit-a", "hit-b", "hit-c"]

        # concurrent GETs aggregate through the batcher
        hits = []

        def client(i):
            hits.append(json.load(urlopen(f"{base}/search?q=q{i}", timeout=30))["results"][0]["uuid"])

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert sorted(hits) == sorted(f"hit-q{i}" for i in range(8))

        # error surface: missing q
        import urllib.error

        with pytest.raises(urllib.error.HTTPError) as ei:
            urlopen(f"{base}/search", timeout=10)
        assert ei.value.code == 400


def test_http_healthz_health_fn_503(pkg):
    """An extra liveness source (multi-host stall detection) flips /healthz
    to 503 when it reports ok=False — orchestrator restart hook."""
    import json
    import urllib.error
    from urllib.request import urlopen

    state = {"ok": True}

    def batch_fn(queries):
        return [[] for _ in queries]

    def health_fn():
        return {"ok": state["ok"], "multihost": {"stalled": not state["ok"]}}

    with pkg.RetrievalHTTPServer(batch_fn, port=0, health_fn=health_fn) as srv:
        host, port = srv.address
        base = f"http://{host}:{port}"
        payload = json.load(urlopen(f"{base}/healthz", timeout=10))
        assert payload["ok"] is True and payload["multihost"]["stalled"] is False
        state["ok"] = False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urlopen(f"{base}/healthz", timeout=10)
        assert ei.value.code == 503
        body = json.loads(ei.value.read())
        assert body["ok"] is False and body["multihost"]["stalled"] is True


def test_cancelled_future_does_not_kill_worker(pkg):
    """A caller cancelling its future must not crash the worker thread
    (resolving a cancelled Future raises InvalidStateError)."""
    release = threading.Event()

    def batch_fn(queries):
        release.wait(5)
        return [[{"uuid": q}] for q in queries]

    with pkg.MicroBatcher(batch_fn, max_batch=4, max_wait_ms=1.0) as mb:
        f1 = mb.submit("a")
        cancelled = f1.cancel()  # pending future: cancellable
        release.set()
        # the worker must survive and serve subsequent requests
        f2 = mb.submit("b")
        assert f2.result(timeout=10) == [{"uuid": "b"}]
    if cancelled:
        assert f1.cancelled()


def test_close_drains_stranded_futures(pkg):
    """No submit() may strand its caller forever across a close() race —
    the future either resolves, errors, or close() fails it."""
    def batch_fn(queries):
        return [[] for _ in queries]

    mb = pkg.MicroBatcher(batch_fn, max_batch=4, max_wait_ms=1.0)
    futs = [mb.submit(str(i)) for i in range(8)]
    mb.close()
    for f in futs:
        # must terminate promptly one way or another
        try:
            f.result(timeout=5)
        except Exception:
            pass
        assert f.done()


def test_http_bad_n_returns_400(pkg):
    import json as json_mod
    from urllib.request import urlopen
    from urllib.error import HTTPError

    def batch_fn(queries):
        return [[{"uuid": "u", "score": 1.0}] for _ in queries]

    with pkg.RetrievalHTTPServer(batch_fn, port=0, max_wait_ms=1.0) as srv:
        host, port = srv.address
        with pytest.raises(HTTPError) as ei:
            urlopen(f"http://{host}:{port}/search?q=x&n=abc")
        assert ei.value.code == 400
        with pytest.raises(HTTPError) as ei:
            urlopen(f"http://{host}:{port}/search?q=x&n=-2")
        assert ei.value.code == 400
        # valid n still works
        body = json_mod.loads(urlopen(f"http://{host}:{port}/search?q=x&n=1").read())
        assert body["results"] == [{"uuid": "u", "score": 1.0}]


def test_http_document_endpoints(pkg):
    """POST/DELETE /documents: update hooks, validation, error mapping."""
    import json as json_mod
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen

    calls = []

    def add_fn(img, txt, uuids):
        if "dup" in uuids:
            raise pkg.DuplicateUUIDError("duplicate uuids: ['dup']")
        if img.shape[1] != 2:
            raise ValueError(f"expected image/text of shape (n, 2); got {img.shape}")
        calls.append(("add", img.shape, txt.shape, list(uuids)))

    def remove_fn(uuids):
        if "ghost" in uuids:
            raise KeyError("unknown uuids: ['ghost']")
        calls.append(("remove", list(uuids)))

    def batch_fn(queries):
        return [[] for _ in queries]

    def post(base, path, payload, method="POST"):
        req = Request(
            f"{base}{path}", data=json_mod.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method=method,
        )
        return json_mod.load(urlopen(req, timeout=10))

    with pkg.RetrievalHTTPServer(
        batch_fn, port=0, max_wait_ms=1.0,
        add_documents_fn=add_fn, remove_documents_fn=remove_fn,
    ) as srv:
        base = "http://{}:{}".format(*srv.address)
        doc = {"uuid": "d1", "image_embedding": [1.0, 0.0], "text_embedding": [0.0, 1.0]}
        assert post(base, "/documents", {"documents": [doc]}) == {"added": 1}
        assert post(base, "/documents", {"uuids": ["d1"]}, "DELETE") == {"removed": 1}
        assert calls == [("add", (1, 2), (1, 2), ["d1"]), ("remove", ["d1"])]

        for payload, code, method in [
            ({"documents": []}, 400, "POST"),  # empty list
            ({"documents": [{"uuid": "x"}]}, 400, "POST"),  # missing embeddings
            ({"documents": [dict(doc, uuid="dup")]}, 409, "POST"),  # duplicate
            # wrong embedding dimensionality: malformed payload, NOT conflict
            ({"documents": [{"uuid": "d9", "image_embedding": [1.0, 0.0, 0.0],
                             "text_embedding": [0.0, 1.0, 0.0]}]}, 400, "POST"),
            ({"uuids": []}, 400, "DELETE"),
            ({"uuids": ["ghost"]}, 404, "DELETE"),
        ]:
            with pytest.raises(HTTPError) as ei:
                post(base, "/documents", payload, method)
            assert ei.value.code == code, (payload, method)

    # without hooks the endpoints answer 501 (search-only deployment)
    with pkg.RetrievalHTTPServer(batch_fn, port=0, max_wait_ms=1.0) as srv:
        base = "http://{}:{}".format(*srv.address)
        with pytest.raises(HTTPError) as ei:
            post(base, "/documents", {"documents": [doc]})
        assert ei.value.code == 501
        with pytest.raises(HTTPError) as ei:
            post(base, "/documents", {"uuids": ["d1"]}, "DELETE")
        assert ei.value.code == 501


def test_http_image_search(pkg):
    """POST /search_image: base64 decode, per-request preprocess isolation,
    501 when not wired, 400 on bad base64 / bad image."""
    import base64
    import json as json_mod
    import urllib.error
    from urllib.request import Request, urlopen

    def post(base, path, payload):
        req = Request(
            f"{base}{path}", data=json_mod.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        return json_mod.load(urlopen(req, timeout=10))

    def batch_fn(queries):
        return [[] for _ in queries]

    # not wired -> 501
    with pkg.RetrievalHTTPServer(batch_fn, port=0, max_wait_ms=1.0) as srv:
        base = "http://{}:{}".format(*srv.address)
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(base, "/search_image", {"image": base64.b64encode(b"x").decode()})
        assert ei.value.code == 501

    # image_batch_fn without per-request decode isolation is a footgun
    # (one corrupt image would 502 the whole shared micro-batch): rejected
    with pytest.raises(ValueError, match="image_preprocess_fn"):
        pkg.RetrievalHTTPServer(batch_fn, port=0, image_batch_fn=lambda x: x)

    def image_batch_fn(imgs):
        # imgs arrive preprocessed (here: upper-cased by the fake preprocess)
        return [[{"uuid": f"img-{b.decode()}", "score": 1.0}] for b in imgs]

    def preprocess_fn(blobs):
        out = []
        for b in blobs:
            if b == b"corrupt":
                raise ValueError("cannot decode")
            out.append(b.upper())
        return out

    with pkg.RetrievalHTTPServer(
        batch_fn, port=0, max_wait_ms=1.0,
        image_batch_fn=image_batch_fn, image_preprocess_fn=preprocess_fn,
    ) as srv:
        base = "http://{}:{}".format(*srv.address)
        b64 = lambda b: base64.b64encode(b).decode()  # noqa: E731
        out = post(base, "/search_image", {"image": b64(b"cat")})
        assert out["results"][0]["uuid"] == "img-CAT"  # single image -> one list
        out = post(base, "/search_image", {"images": [b64(b"a"), b64(b"b")], "n": 1})
        assert [r[0]["uuid"] for r in out["results"]] == ["img-A", "img-B"]
        # bad base64 -> 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(base, "/search_image", {"image": "not-base64!!!"})
        assert ei.value.code == 400
        # preprocess failure (corrupt image) -> 400, isolated to this request
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(base, "/search_image", {"image": b64(b"corrupt")})
        assert ei.value.code == 400
        # the server still serves after the failure
        out = post(base, "/search_image", {"image": b64(b"ok")})
        assert out["results"][0]["uuid"] == "img-OK"
        # missing payload -> 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(base, "/search_image", {})
        assert ei.value.code == 400
        # /healthz reports the image batcher alongside the text one
        health = json_mod.load(urlopen(f"{base}/healthz", timeout=10))
        assert health["image_stats"]["served"] >= 4


def test_http_raw_document_ingest(pkg):
    """POST /documents with base64 images + texts encodes server-side."""
    import base64
    import json as json_mod
    import urllib.error
    from urllib.request import Request, urlopen

    import numpy as np

    added = []

    def add_fn(img, txt, uuids):
        added.append((img.shape, txt.shape, list(uuids)))

    def encode_fn(blobs, texts):
        if any(b == b"corrupt" for b in blobs):
            raise ValueError("cannot decode image")
        n = len(blobs)
        return np.ones((n, 4), np.float32), np.ones((n, 4), np.float32)

    def post(base, payload):
        req = Request(
            f"{base}/documents", data=json_mod.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        return json_mod.load(urlopen(req, timeout=10))

    b64 = lambda b: base64.b64encode(b).decode()  # noqa: E731
    batch_fn = lambda qs: [[] for _ in qs]  # noqa: E731
    with pkg.RetrievalHTTPServer(
        batch_fn, port=0, max_wait_ms=1.0,
        add_documents_fn=add_fn, encode_documents_fn=encode_fn,
    ) as srv:
        base = "http://{}:{}".format(*srv.address)
        out = post(base, {"documents": [
            {"uuid": "r1", "image": b64(b"img1"), "text": "a vase"},
            {"uuid": "r2", "image": b64(b"img2"), "text": "a coin"},
        ]})
        assert out == {"added": 2}
        assert added[-1] == ((2, 4), (2, 4), ["r1", "r2"])
        # mixed raw + embedding form in one request -> 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(base, {"documents": [
                {"uuid": "a", "image": b64(b"x"), "text": "t"},
                {"uuid": "b", "image_embedding": [1, 0], "text_embedding": [0, 1]},
            ]})
        assert ei.value.code == 400
        # corrupt image -> 400 (client data error, not 502)
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(base, {"documents": [{"uuid": "c", "image": b64(b"corrupt"), "text": "t"}]})
        assert ei.value.code == 400

    # raw form without the encode hook -> 501
    with pkg.RetrievalHTTPServer(batch_fn, port=0, max_wait_ms=1.0, add_documents_fn=add_fn) as srv:
        base = "http://{}:{}".format(*srv.address)
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(base, {"documents": [{"uuid": "d", "image": b64(b"x"), "text": "t"}]})
        assert ei.value.code == 501


def test_http_metrics_endpoint_and_idempotent_close(pkg):
    """GET /metrics renders Prometheus text; close() twice is a no-op."""
    import json as json_mod
    from urllib.request import urlopen

    def batch_fn(queries):
        return [[{"uuid": q, "score": 1.0}] for q in queries]

    srv = pkg.RetrievalHTTPServer(
        batch_fn, port=0, max_wait_ms=1.0,
        image_batch_fn=lambda imgs: [[] for _ in imgs],
        image_preprocess_fn=lambda blobs: blobs,
    )
    with srv:
        base = "http://{}:{}".format(*srv.address)
        json_mod.load(urlopen(f"{base}/search?q=x", timeout=10))
        body = urlopen(f"{base}/metrics", timeout=10).read().decode()
        assert 'kemr_requests_served_total{modality="text"} 1' in body
        assert 'kemr_requests_served_total{modality="image"} 0' in body
        assert "# TYPE kemr_request_latency_ms summary" in body
        assert 'quantile="0.5"' in body
    srv.close()  # second close (after __exit__'s) must be a clean no-op


def test_http_close_without_start_does_not_deadlock(pkg):

    srv = pkg.RetrievalHTTPServer(lambda qs: [[] for _ in qs], port=0, max_wait_ms=1.0)
    done = threading.Event()

    def _close():
        srv.close()
        done.set()

    t = threading.Thread(target=_close, daemon=True)
    t.start()
    assert done.wait(5), "close() on a never-started server deadlocked"


def test_latency_stats_and_backpressure(pkg):
    """stats reports p50/p95/p99 request latency; max_pending load-sheds
    with Overloaded instead of queueing without bound."""

    release = threading.Event()

    def batch_fn(queries):
        release.wait(10)
        return [[{"uuid": q}] for q in queries]

    mb = pkg.MicroBatcher(batch_fn, max_batch=2, max_wait_ms=1.0, max_pending=3)
    futs = [mb.submit(str(i)) for i in range(3)]  # fills the pending budget
    with pytest.raises(pkg.Overloaded):
        mb.submit("overflow")
    assert mb.stats["rejected"] == 1
    assert mb.stats["pending"] == 3
    release.set()
    for f in futs:
        f.result(timeout=10)
    stats = mb.stats
    assert stats["pending"] == 0
    assert stats["latency_ms"]["n"] == 3
    assert stats["latency_ms"]["p50"] <= stats["latency_ms"]["p99"]
    # budget freed: submissions accepted again
    assert mb.retrieve("again", timeout=10) == [{"uuid": "again"}]
    mb.close()


def test_http_backpressure_returns_503(pkg):
    import json as json_mod
    from urllib.error import HTTPError
    from urllib.request import urlopen

    release = threading.Event()

    def batch_fn(queries):
        release.wait(10)
        return [[] for _ in queries]

    with pkg.RetrievalHTTPServer(batch_fn, port=0, max_wait_ms=1.0, max_pending=1) as srv:
        host, port = srv.address
        codes = []

        def client():
            try:
                urlopen(f"http://{host}:{port}/search?q=x", timeout=30)
                codes.append(200)
            except HTTPError as e:
                codes.append(e.code)

        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
            time.sleep(0.1)  # ensure the first occupies the pending slot
        release.set()
        for t in threads:
            t.join()
        assert 503 in codes and 200 in codes, codes
        health = json_mod.loads(urlopen(f"http://{host}:{port}/healthz").read())
        assert health["stats"]["rejected"] >= 1


def test_http_result_cache_hit_and_invalidation(pkg):
    """Repeated (query, alpha) pairs skip the backend; corpus mutations
    invalidate, and an in-flight search cannot repopulate stale results."""
    import json as json_mod
    from urllib.request import Request, urlopen

    calls = []

    def batch_fn(queries):
        calls.append(list(queries))
        return [[{"uuid": f"v{len(calls)}-{q}", "score": 1.0}] for q in queries]

    def post(base, path, payload, method="POST"):
        req = Request(
            f"{base}{path}", data=json_mod.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method=method,
        )
        return json_mod.load(urlopen(req, timeout=10))

    with pkg.RetrievalHTTPServer(
        batch_fn, port=0, max_wait_ms=1.0, result_cache_size=8,
        add_documents_fn=lambda img, txt, uuids: None,
    ) as srv:
        base = "http://{}:{}".format(*srv.address)
        a = json_mod.load(urlopen(f"{base}/search?q=vase", timeout=10))
        b = json_mod.load(urlopen(f"{base}/search?q=vase", timeout=10))
        assert a == b and len(calls) == 1  # second request never hit the backend
        # corpus mutation invalidates the cache
        doc = {"uuid": "d1", "image_embedding": [1.0, 0.0], "text_embedding": [0.0, 1.0]}
        post(base, "/documents", {"documents": [doc]})
        c = json_mod.load(urlopen(f"{base}/search?q=vase", timeout=10))
        assert len(calls) == 2 and c["results"][0]["uuid"] == "v2-vase"


def test_length_bucketing_splits_micro_batches(pkg):
    """With a length_bucket_fn each dispatched batch is single-bucket, the
    widest bucket dispatches first, and every caller still gets its own
    result."""
    calls = []

    def batch_fn(queries):
        calls.append(list(queries))
        return [[{"uuid": q}] for q in queries]

    bucket = lambda q: 32 if len(q) > 6 else 16  # noqa: E731

    with pkg.MicroBatcher(
        batch_fn, max_batch=64, max_wait_ms=200.0,
        pad_to_bucket=False, length_bucket_fn=bucket,
    ) as mb:
        queries = ["short"] * 5 + ["a much longer query"] * 3 + ["tiny"] * 2
        futs = [mb.submit(q) for q in queries]
        results = [f.result(timeout=10) for f in futs]
    assert [r[0]["uuid"] for r in results] == queries
    # every dispatched group is single-bucket
    for call in calls:
        assert len({bucket(q) for q in call}) == 1, call
    # both buckets were served, wide group first within its micro-batch
    first_two = [bucket(c[0]) for c in calls[:2]]
    assert set(first_two) == {16, 32}
    assert first_two[0] == 32
    assert mb.stats["served"] == 10


def test_length_bucketing_bucket_fn_errors_stay_per_request(pkg):
    """A bucket fn that raises must not kill the worker — the queries fall
    into a shared group and batch_fn decides their fate."""

    def batch_fn(queries):
        return [[{"uuid": q}] for q in queries]

    def bad_bucket(q):
        if q == "boom":
            raise ValueError("no bucket")
        return 16

    with pkg.MicroBatcher(
        batch_fn, max_wait_ms=50.0, pad_to_bucket=False, length_bucket_fn=bad_bucket
    ) as mb:
        futs = [mb.submit(q) for q in ("boom", "ok")]
        results = [f.result(timeout=10) for f in futs]
    assert [r[0]["uuid"] for r in results] == ["boom", "ok"]
    # and the batcher still serves after the bucket-fn failure
    assert mb.stats["served"] == 2


def test_threaded_callers_end_to_end():
    """Concurrent callers through the port's engine on the CPU: fewer
    searches than queries, every caller gets the direct search's top hit."""
    import torch

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as M
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.engine import RetrievalEngine

    tok = CLIPTokenizer([("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")])
    arch = M.CLIPArch(16, 32, 1, 32, 16, 16, tok.vocab_size, 32, 2, 1, vision_heads=2)
    model = M.build_model("tiny", dtype=torch.float32, seed=0, arch=arch)
    rng = np.random.default_rng(0)
    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    store = TES.EmbeddingStore(
        image=norm(rng.standard_normal((50, 16))), text=norm(rng.standard_normal((50, 16))),
        uuids=[f"u{i}" for i in range(50)],
    )
    engine = RetrievalEngine(CLIPRetrieval(model, tok, store, device="cpu", top_k=5, use_fused_encoder=False))
    expected = engine.retrieve_text_noknowledge("hello cat")[0]["uuid"]

    with TSV.MicroBatcher(engine.retrieve_text_noknowledge_batch, max_batch=16, max_wait_ms=30.0) as mb:
        out = []

        def caller():
            out.append(mb.retrieve("hello cat", timeout=60)[0]["uuid"])

        threads = [threading.Thread(target=caller) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert out == [expected] * 12
    assert mb.stats["batches"] < 12


class _SlowDict(dict):
    """A histogram that takes its time to store a count (and lets other
    threads run meanwhile), so that a reader which does not wait for the
    writer sees the counters half updated."""

    def __setitem__(self, key, value):
        time.sleep(0.002)
        super().__setitem__(key, value)


def test_stats_is_safe_while_new_batch_sizes_dispatch():
    """The port's repair: ``stats`` snapshots the counters and the histogram
    under the lock the worker writes them under, so threads that read it
    without pause while batches of ever new sizes dispatch see no error and
    never a torn snapshot: the histogram always adds up to the batch and
    query counts."""
    errors, snapshots = [], []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                s = mb.stats
                snapshots.append(s)
                assert sum(n * c for n, c in s["batch_size_hist"].items()) == s["served"], s
                assert sum(s["batch_size_hist"].values()) == s["batches"], s
            except Exception as e:  # noqa: BLE001
                errors.append(e)

    release = threading.Event()

    def batch_fn(queries):
        release.wait(5)
        return [[{"uuid": q}] for q in queries]

    mb = TSV.MicroBatcher(batch_fn, max_batch=512, max_wait_ms=20.0, pad_to_bucket=False)
    mb._batch_size_hist = _SlowDict()
    readers = [threading.Thread(target=hammer) for _ in range(2)]
    for t in readers:
        t.start()
    served = 0
    try:
        for size in range(1, 41):
            release.clear()
            futs = [mb.submit(f"q{size}-{i}") for i in range(size)]
            release.set()
            for f in futs:
                f.result(timeout=10)
            served += size
    finally:
        stop.set()
        for t in readers:
            t.join()
        mb.close()
    assert not errors, errors[:3]
    stats = mb.stats
    assert stats["served"] == served and len(snapshots) > 40
    assert sum(n * c for n, c in stats["batch_size_hist"].items()) == served


def _script():
    """Every endpoint and every error: (method, path, JSON body or None)."""
    import base64

    b64 = lambda b: base64.b64encode(b).decode()  # noqa: E731
    doc = {"uuid": "d1", "image_embedding": [1.0, 0.0], "text_embedding": [0.0, 1.0]}
    return [
        ("GET", "/healthz", None),
        ("GET", "/search?q=vase&n=2", None),
        ("GET", "/search?q=vase&n=2", None),  # a result-cache hit
        ("GET", "/search?q=vase&alpha=0.25", None),
        ("GET", "/search?q=vase&n=abc", None),
        ("GET", "/search?q=vase&n=0", None),
        ("GET", "/search?q=vase&alpha=nan", None),
        ("GET", "/search?q=vase&alpha=high", None),
        ("GET", "/search", None),
        ("GET", "/nowhere", None),
        ("POST", "/search", {"query": "a", "n": 1}),
        ("POST", "/search", {"queries": ["a", "b", "c"], "alpha": 0.9}),
        ("POST", "/search", {"query": "a", "n": -1}),
        ("POST", "/search", {"query": "a", "alpha": "inf"}),
        ("POST", "/search", {}),
        ("POST", "/search", {"query": "a", "allow_uuids": ["u1", "u3"]}),
        ("POST", "/search", {"queries": ["a", "b"], "deny_uuids": ["u1"], "alpha": 0.4}),
        ("POST", "/search", {"query": "ivf", "allow_uuids": ["u1"]}),  # the hook's ValueError
        ("POST", "/search", {"queries": ["a", "b"], "candidates": [["u1", "u2"], []]}),
        ("POST", "/search", {"query": "a", "candidates": [["u1"]], "allow_uuids": ["u1"]}),
        ("POST", "/search", {"query": "a", "fused": True}),
        ("POST", "/search_image", {"image": b64(b"cat")}),
        ("POST", "/search_image", {"images": [b64(b"a"), b64(b"b")], "n": 1}),
        ("POST", "/search_image", {"image": "not-base64!!!"}),
        ("POST", "/search_image", {"image": b64(b"corrupt")}),
        ("POST", "/search_image", {}),
        ("POST", "/documents", {"documents": [doc]}),
        ("POST", "/documents", {"documents": [dict(doc, uuid="dup")]}),
        ("POST", "/documents", {"documents": [{"uuid": "x"}]}),
        ("POST", "/documents", {"documents": []}),
        ("POST", "/documents", {"documents": [{"uuid": "r1", "image": b64(b"img"), "text": "a vase"}]}),
        ("POST", "/documents", {"documents": [{"uuid": "r2", "image": b64(b"corrupt"), "text": "t"}]}),
        ("GET", "/search?q=vase&n=2", None),  # the cache was emptied by the update
        ("DELETE", "/documents", {"uuids": ["d1"]}),
        ("DELETE", "/documents", {"uuids": ["ghost"]}),
        ("DELETE", "/documents", {"uuids": []}),
        ("POST", "/snapshot", {}),
        ("POST", "/nowhere", {}),
        ("GET", "/metrics", None),
    ]


def _hooks(calls, duplicate_error):
    """Fake hooks shared by both servers; ``calls`` records what reached them,
    and a duplicate uuid raises the server's own ``DuplicateUUIDError``."""
    def hit(tag, q, alpha=None):
        return {"uuid": f"{tag}-{q}", "score": 1.0 if alpha is None else float(alpha)}

    def batch_fn(queries):
        calls.append(("batch", list(queries)))
        return [[hit("t", q), {"uuid": "u2", "score": 0.5}] for q in queries]

    def alphas_batch_fn(queries, alphas):
        calls.append(("alphas", list(queries), list(alphas)))
        return [[hit("a", q, a), {"uuid": "u2", "score": 0.5}] for q, a in zip(queries, alphas)]

    def filtered_batch_fn(queries, alphas, allow, deny):
        if "ivf" in queries:
            raise ValueError("filtered search needs an exact corpus scan")
        calls.append(("filtered", list(queries), list(alphas), allow, deny))
        return [[hit("f", q, a)] for q, a in zip(queries, alphas)]

    def candidates_batch_fn(queries, candidates, alphas):
        calls.append(("candidates", list(queries), candidates, list(alphas)))
        return [[{"uuid": u, "score": 0.1} for u in c] for c in candidates]

    def add_fn(img, txt, uuids):
        if "dup" in uuids:
            raise duplicate_error("duplicate uuids: ['dup']")
        calls.append(("add", img.shape, txt.shape, list(uuids)))

    def remove_fn(uuids):
        if "ghost" in uuids:
            raise KeyError("unknown uuids: ['ghost']")
        calls.append(("remove", list(uuids)))

    def encode_fn(blobs, texts):
        if any(b == b"corrupt" for b in blobs):
            raise ValueError("cannot decode image")
        return np.ones((len(blobs), 2), np.float32), np.ones((len(blobs), 2), np.float32)

    def preprocess_fn(blobs):
        if any(b == b"corrupt" for b in blobs):
            raise ValueError("cannot decode")
        return [b.upper() for b in blobs]

    def image_batch_fn(imgs):
        return [[{"uuid": f"img-{b.decode()}", "score": 1.0}] for b in imgs]

    return dict(
        alphas_batch_fn=alphas_batch_fn, filtered_batch_fn=filtered_batch_fn,
        candidates_batch_fn=candidates_batch_fn, add_documents_fn=add_fn, remove_documents_fn=remove_fn,
        encode_documents_fn=encode_fn, snapshot_fn=lambda: {"path": "store.npz", "rows": 3},
        image_batch_fn=image_batch_fn, image_preprocess_fn=preprocess_fn, result_cache_size=8,
    ), batch_fn


def _drop_timings(payload):
    if isinstance(payload, dict):
        return {k: _drop_timings(v) for k, v in payload.items() if k != "latency_ms"}
    return payload


def _run_script(pkg):
    import json
    from urllib.error import HTTPError
    from urllib.request import Request, urlopen

    calls = []
    hooks, batch_fn = _hooks(calls, pkg.DuplicateUUIDError)
    answers = []
    with pkg.RetrievalHTTPServer(batch_fn, port=0, max_wait_ms=1.0, **hooks) as srv:
        base = "http://{}:{}".format(*srv.address)
        for method, path, body in _script():
            data = None if body is None else json.dumps(body).encode()
            req = Request(base + path, data=data, method=method, headers={"Content-Type": "application/json"})
            try:
                with urlopen(req, timeout=10) as r:
                    code, raw = r.status, r.read()
            except HTTPError as e:
                code, raw = e.code, e.read()
            if path == "/metrics":
                text = [line for line in raw.decode().splitlines() if "quantile" not in line]
                answers.append((method, path, code, text))
            else:
                answers.append((method, path, code, _drop_timings(json.loads(raw))))
    return answers, calls


def test_http_servers_answer_alike():
    want, want_calls = _run_script(PACKAGES["jax"])
    got, got_calls = _run_script(PACKAGES["port"])
    for a, b in zip(want, got):
        assert b == a
    assert len(got) == len(want) == len(_script())
    assert got_calls == want_calls
    codes = [c for _, _, c, _ in got]
    assert {200, 400, 404, 409, 501} <= set(codes)
    assert sum(1 for c in got_calls if c[0] == "batch") + sum(1 for c in got_calls if c[0] == "alphas") < 12


def test_launch_counters_keep_every_count_under_threads():
    """The daemon launches from several threads at once: a count changes only
    under the counters' lock (a thread that counts waits while another holds
    it, as ``launch_counts`` does for its snapshot), and no count is lost
    however often the interpreter switches threads."""
    import sys

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch

    fn = dispatch.counted(lambda: None)
    try:
        with dispatch._COUNT_LOCK:
            t = threading.Thread(target=dispatch.count_launch, args=(fn,))
            t.start()
            t.join(0.2)
            assert t.is_alive() and fn.launches == 0  # waits for the lock
        t.join(10)
        assert not t.is_alive() and fn.launches == 1
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=lambda: [dispatch.count_launch(fn) for _ in range(1000)])
                       for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert fn.launches == 1 + 16 * 1000
    finally:
        dispatch._COUNTED.pop(fn.__name__)
