"""Stdlib HTTP serving front-end over :class:`MicroBatcher`.

The port's copy of ``knowledge_enhanced_multimodal_retrieval_tpu/retrieval/http_server.py``
(pure host code; it imports only the port's ``embedding_store`` and
``server``): a ``ThreadingHTTPServer`` whose request threads block on
MicroBatcher futures, so concurrent HTTP clients aggregate into batched
searches on the device.

Endpoints:
- ``GET /healthz``                      -> ``{"ok": true, "stats": {...}}``
- ``GET /search?q=<query>[&n=<top-n>][&alpha=<blend>]`` ->
  ``{"query", "results"}`` (per-request ``alpha`` needs the alphas hook;
  the blend is an operand, so mixed alphas share one micro-batch)
- ``POST /search`` with JSON body ``{"query": "...", "n": 20}`` or
  ``{"queries": ["...", ...]}``        -> one or many result lists;
  optional ``"allow_uuids"`` / ``"deny_uuids"`` (hard filter — only
  eligible documents can appear; the row mask is an operand of the
  masked scan) or ``"candidates"`` (per-query uuid lists,
  scored exactly on the host — the knowledge-constrained mode); filtered
  requests bypass the shared micro-batch and the result cache; optional
  ``"fused": true`` (when a trained fusion head is wired) rescores stage-1
  candidates with the learned head instead of the linear blend
- ``POST /search_image`` (when an image search hook is wired) with
  ``{"image": "<base64 PNG/JPEG>", "n": 20}`` or ``{"images": [...]}`` ->
  visual search over the same corpus; image requests micro-batch through
  their own aggregator (their batches run the vision tower, not the text one)
- ``POST /documents`` (when update hooks are wired) with
  ``{"documents": [{"uuid", "image_embedding", "text_embedding"}, ...]}``
  -> live corpus ingest; with an encode hook wired, RAW artifacts
  ``{"uuid", "image": <base64>, "text": "..."}`` are encoded server-side
  (no offline precompute pass). ``DELETE /documents`` with
  ``{"uuids": [...]}`` retires rows. Concurrent searches keep serving the
  old corpus until the update swaps in (``CLIPRetrieval`` corpus state is
  one atomic reference).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np

from .embedding_store import DuplicateUUIDError
from .server import MicroBatcher, Overloaded

# exception types that mean "the CLIENT's data is bad" (HTTP 400) rather
# than a backend failure (502): decode/shape errors, incl. PIL's
# cannot-identify error when available
try:
    from PIL import UnidentifiedImageError as _PILError
except Exception:  # pragma: no cover — PIL is a baked-in dependency
    _PILError = ValueError
_CLIENT_DATA_ERRORS = (ValueError, TypeError, KeyError, _PILError)


class _AlphaNotEnabled(ValueError):
    """Per-request alpha requested but no alphas hook is wired."""


def _parse_alpha(raw):
    """Optional blend parameter: FINITE float, else ``(None, error)``.

    NaN/inf are rejected here: NaN poisons every blended score (the scan
    degrades to filler results, a plain path would even emit invalid JSON),
    so it is a client error, not a servable value."""
    import math

    if raw is None:
        return None, None
    try:
        a = float(raw)
    except (TypeError, ValueError):
        return None, f"alpha must be a number, got {raw!r}"
    if not math.isfinite(a):
        return None, f"alpha must be finite, got {raw!r}"
    return a, None


def _parse_n(raw):
    """Validate a top-n parameter: positive int, else ``(None, error)``."""
    try:
        n = int(raw)
    except (TypeError, ValueError):
        return None, f"n must be an integer, got {raw!r}"
    if n < 1:
        return None, f"n must be >= 1, got {n}"
    return n, None


def _prometheus_metrics(batcher, image_batcher) -> str:
    """Render MicroBatcher stats in Prometheus text exposition format."""
    lines = [
        "# TYPE kemr_requests_served_total counter",
        "# TYPE kemr_requests_rejected_total counter",
        "# TYPE kemr_batches_total counter",
        "# TYPE kemr_requests_pending gauge",
        "# TYPE kemr_request_latency_ms summary",
    ]
    for modality, b in (("text", batcher), ("image", image_batcher)):
        if b is None:
            continue
        s = b.stats
        tag = f'{{modality="{modality}"}}'
        lines += [
            f"kemr_requests_served_total{tag} {s['served']}",
            f"kemr_requests_rejected_total{tag} {s['rejected']}",
            f"kemr_batches_total{tag} {s['batches']}",
            f"kemr_requests_pending{tag} {s['pending']}",
        ]
        quantiles = {"p50": "0.5", "p95": "0.95", "p99": "0.99"}
        for q, v in s.get("latency_ms", {}).items():
            if q not in quantiles:
                continue
            lines.append(
                f'kemr_request_latency_ms{{modality="{modality}",quantile="{quantiles[q]}"}} {v}'
            )
    return "\n".join(lines) + "\n"


class RetrievalHTTPServer:
    """HTTP front-end; construct, then :meth:`serve_forever` (or use as a
    context manager around background serving via :meth:`start`)."""

    def __init__(
        self,
        batch_fn: Callable[[Sequence[str]], List[List[dict]]],
        host: str = "127.0.0.1",
        port: int = 8080,
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        default_n: int = 20,
        max_pending: int = 0,
        add_documents_fn: Optional[Callable] = None,
        remove_documents_fn: Optional[Callable] = None,
        encode_documents_fn: Optional[Callable] = None,
        alphas_batch_fn: Optional[Callable] = None,
        snapshot_fn: Optional[Callable] = None,
        image_batch_fn: Optional[Callable] = None,
        image_preprocess_fn: Optional[Callable] = None,
        max_image_batch: int = 64,
        result_cache_size: int = 0,
        filtered_batch_fn: Optional[Callable] = None,
        candidates_batch_fn: Optional[Callable] = None,
        fused_batch_fn: Optional[Callable] = None,
        length_bucket_fn: Optional[Callable] = None,
        health_fn: Optional[Callable[[], dict]] = None,
    ):
        # with an alphas hook, batch items are (query, alpha-or-None) pairs
        # and the hook resolves defaults — per-request blends ride the same
        # micro-batch because alpha is an operand of the scan
        per_request_alpha = alphas_batch_fn is not None

        def _pairs_fn(items):
            return alphas_batch_fn([q for q, _ in items], [a for _, a in items])

        # length bucketing (opt-in, e.g. CLIPRetrieval.seq_bucket): split
        # each micro-batch by seq bucket so short queries keep their cheap
        # encode; under per-request alpha the batch items are
        # (query, alpha) pairs, so unwrap the query first
        bucket_fn = length_bucket_fn
        if bucket_fn is not None and per_request_alpha:
            _raw_bucket = bucket_fn
            bucket_fn = lambda item: _raw_bucket(item[0])  # noqa: E731

        self.batcher = MicroBatcher(
            _pairs_fn if per_request_alpha else batch_fn,
            max_batch=max_batch, max_wait_ms=max_wait_ms, max_pending=max_pending,
            length_bucket_fn=bucket_fn,
        )
        batcher = self.batcher

        # opt-in result cache: popular (query, alpha) pairs skip the device
        # entirely (the MicroBatcher already amortizes, this removes repeat
        # work). Invalidated on every corpus mutation — a stale hit would
        # serve retired uuids.
        from collections import OrderedDict

        cache_lock = threading.Lock()
        result_cache: "OrderedDict[tuple, list]" = OrderedDict()
        cache_gen = [0]  # bumped on every corpus mutation

        def cache_get(key):
            if not result_cache_size:
                return None
            with cache_lock:
                hit = result_cache.get(key)
                if hit is not None:
                    result_cache.move_to_end(key)
                return hit

        def cache_put(key, value, gen):
            if not result_cache_size:
                return
            with cache_lock:
                if gen != cache_gen[0]:
                    return  # result computed against a RETIRED corpus: drop
                result_cache[key] = value
                result_cache.move_to_end(key)
                while len(result_cache) > result_cache_size:
                    result_cache.popitem(last=False)

        def cache_clear():
            with cache_lock:
                result_cache.clear()
                cache_gen[0] += 1

        class _Done:
            """Future-alike resolving to an already-cached result."""

            def __init__(self, value):
                self._value = value

            def result(self, timeout=None):
                return self._value

        def submit_query(q, alpha=None):
            key = (q, alpha)
            hit = cache_get(key)
            if hit is not None:
                return _Done(hit)
            if per_request_alpha:
                fut = batcher.submit((q, alpha))
            else:
                if alpha is not None:
                    raise _AlphaNotEnabled("per-request alpha not enabled")
                fut = batcher.submit(q)
            if result_cache_size:
                gen = cache_gen[0]  # snapshot BEFORE the search runs
                fut.add_done_callback(
                    lambda f: cache_put(key, f.result(), gen) if f.exception() is None else None
                )
            return fut
        if image_batch_fn is not None and image_preprocess_fn is None:
            # decode MUST happen on the request thread: inside the shared
            # micro-batch, one corrupt image would raise in batch_fn and
            # 502 every other caller in the same window
            raise ValueError(
                "image_batch_fn requires image_preprocess_fn (per-request "
                "decode isolation); pass `lambda blobs: blobs` only if the "
                "batch fn is failure-isolated itself"
            )
        # image queries ride their own aggregator: batching them with text
        # would mix modalities in one list, and their batches ([B, S, S, 3]
        # pixels vs token ids) run another tower anyway
        self.image_batcher = (
            MicroBatcher(
                image_batch_fn, max_batch=max_image_batch,
                max_wait_ms=max_wait_ms, max_pending=max_pending,
            )
            if image_batch_fn is not None
            else None
        )
        image_batcher = self.image_batcher

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet by default
                pass

            def _send(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/healthz":
                    payload = {"ok": True, "stats": batcher.stats}
                    if image_batcher is not None:
                        payload["image_stats"] = image_batcher.stats
                    if health_fn is not None:
                        # extra liveness source (e.g. multi-host lockstep
                        # stall detection): ok=False -> 503 so orchestrator
                        # liveness probes restart the job
                        try:
                            extra = dict(health_fn())
                        except Exception as e:  # noqa: BLE001
                            extra = {"ok": False, "health_fn_error": str(e)}
                        ok = bool(extra.pop("ok", True))
                        payload.update(extra)
                        payload["ok"] = ok
                        self._send(200 if ok else 503, payload)
                        return
                    self._send(200, payload)
                    return
                if url.path == "/metrics":
                    # Prometheus text exposition of the batcher counters
                    body = _prometheus_metrics(batcher, image_batcher).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if url.path == "/search":
                    params = parse_qs(url.query)
                    q = (params.get("q") or [None])[0]
                    if not q:
                        self._send(400, {"error": "missing q parameter"})
                        return
                    n, err = _parse_n((params.get("n") or [default_n])[0])
                    if err:
                        self._send(400, {"error": err})
                        return
                    alpha, err = _parse_alpha((params.get("alpha") or [None])[0])
                    if err:
                        self._send(400, {"error": err})
                        return
                    try:
                        results = submit_query(q, alpha).result()
                    except Overloaded as e:  # load shed -> 503, retryable
                        self._send(503, {"error": str(e)})
                        return
                    except _AlphaNotEnabled as e:
                        self._send(400, {"error": str(e)})
                        return
                    except Exception as e:  # backend failure -> 502
                        self._send(502, {"error": str(e)})
                        return
                    self._send(200, {"query": q, "results": results[:n]})
                    return
                self._send(404, {"error": f"unknown path {url.path}"})

            def _read_json(self):
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    return json.loads(self.rfile.read(length) or b"{}"), None
                except Exception as e:
                    return None, f"bad JSON body: {e}"

            def do_DELETE(self):
                url = urlparse(self.path)
                if url.path != "/documents":
                    self._send(404, {"error": f"unknown path {url.path}"})
                    return
                if remove_documents_fn is None:
                    self._send(501, {"error": "document updates not enabled"})
                    return
                payload, err = self._read_json()
                if err:
                    self._send(400, {"error": err})
                    return
                uuids = payload.get("uuids")
                if not isinstance(uuids, list) or not uuids:
                    self._send(400, {"error": "body needs a non-empty 'uuids' list"})
                    return
                try:
                    remove_documents_fn([str(u) for u in uuids])
                    cache_clear()
                except KeyError as e:
                    self._send(404, {"error": str(e)})
                    return
                except ValueError as e:  # e.g. removal would empty the corpus
                    self._send(409, {"error": str(e)})
                    return
                except Exception as e:
                    self._send(502, {"error": str(e)})
                    return
                self._send(200, {"removed": len(uuids)})

            def _post_documents(self):
                if add_documents_fn is None:
                    self._send(501, {"error": "document updates not enabled"})
                    return
                payload, err = self._read_json()
                if err:
                    self._send(400, {"error": err})
                    return
                docs = payload.get("documents")
                if not isinstance(docs, list) or not docs:
                    self._send(400, {"error": "body needs a non-empty 'documents' list"})
                    return
                try:
                    uuids = [str(d["uuid"]) for d in docs]
                    raw = [d for d in docs if "image" in d]  # raw-artifact form
                    if raw and len(raw) != len(docs):
                        raise ValueError(
                            "mix of raw ('image'/'text') and embedding-form "
                            "documents in one request"
                        )
                    if raw:
                        if encode_documents_fn is None:
                            self._send(501, {"error": "raw-document ingest not enabled"})
                            return
                        import base64

                        blobs = [base64.b64decode(d["image"], validate=True) for d in docs]
                        texts = [str(d["text"]) for d in docs]
                        try:
                            img, txt = encode_documents_fn(blobs, texts)
                        except _CLIENT_DATA_ERRORS as e:  # bad image bytes
                            self._send(400, {"error": f"cannot encode documents: {e}"})
                            return
                        except Exception as e:  # backend/device failure
                            self._send(502, {"error": str(e)})
                            return
                    else:
                        img = np.asarray([d["image_embedding"] for d in docs], np.float32)
                        txt = np.asarray([d["text_embedding"] for d in docs], np.float32)
                except (KeyError, TypeError, ValueError) as e:
                    self._send(400, {
                        "error": "each document needs uuid plus either "
                        "image(base64)+text or image_embedding+text_embedding: "
                        f"{e}"
                    })
                    return
                try:
                    add_documents_fn(img, txt, uuids)
                    cache_clear()
                except DuplicateUUIDError as e:  # conflict with existing docs
                    self._send(409, {"error": str(e)})
                    return
                except ValueError as e:  # malformed payload (dims, zero rows)
                    self._send(400, {"error": str(e)})
                    return
                except Exception as e:
                    self._send(502, {"error": str(e)})
                    return
                self._send(200, {"added": len(uuids)})

            def _post_search_image(self):
                if image_batcher is None:
                    self._send(501, {"error": "image search not enabled"})
                    return
                payload, err = self._read_json()
                if err:
                    self._send(400, {"error": err})
                    return
                n, err = _parse_n(payload.get("n", default_n))
                if err:
                    self._send(400, {"error": err})
                    return
                import base64

                raw = payload.get("images")
                single = "image" in payload and raw is None
                if single:
                    raw = [payload["image"]]
                if not isinstance(raw, list) or not raw:
                    self._send(400, {"error": "body needs 'image' or a non-empty 'images' list"})
                    return
                try:
                    blobs = [base64.b64decode(b, validate=True) for b in raw]
                except Exception as e:
                    self._send(400, {"error": f"images must be base64-encoded: {e}"})
                    return
                if image_preprocess_fn is not None:
                    # decode + preprocess on the REQUEST thread: a corrupt
                    # image fails only its own request (400), never the
                    # micro-batch it would have shared with other callers
                    try:
                        blobs = list(image_preprocess_fn(blobs))
                    except Exception as e:
                        self._send(400, {"error": f"bad image: {e}"})
                        return
                try:
                    futs = [image_batcher.submit(b) for b in blobs]
                    out = [f.result()[:n] for f in futs]
                except Overloaded as e:
                    self._send(503, {"error": str(e)})
                    return
                except Exception as e:  # bad image bytes or backend failure
                    self._send(502, {"error": str(e)})
                    return
                self._send(200, {"results": out[0] if single else out})

            def do_POST(self):
                url = urlparse(self.path)
                if url.path == "/snapshot":
                    # persist the live corpus (ingested docs survive restarts);
                    # the destination is fixed server-side — clients cannot
                    # choose filesystem paths over the wire
                    if snapshot_fn is None:
                        self._send(501, {"error": "snapshot not enabled"})
                        return
                    try:
                        info = snapshot_fn()
                    except Exception as e:
                        self._send(502, {"error": str(e)})
                        return
                    self._send(200, {"saved": True, **(info if isinstance(info, dict) else {})})
                    return
                if url.path == "/documents":
                    self._post_documents()
                    return
                if url.path == "/search_image":
                    self._post_search_image()
                    return
                if url.path != "/search":
                    self._send(404, {"error": f"unknown path {url.path}"})
                    return
                payload, err = self._read_json()
                if err:
                    self._send(400, {"error": err})
                    return
                n, err = _parse_n(payload.get("n", default_n))
                if err:
                    self._send(400, {"error": err})
                    return
                # resolve queries + alphas FIRST: parse problems are client
                # errors (400) and must not share a scope with backend waits
                if "queries" in payload:
                    qs = payload["queries"]
                    raw_alphas = payload.get("alphas", payload.get("alpha"))
                    if raw_alphas is None:
                        alphas = [None] * len(qs)
                    else:
                        raw_list = raw_alphas if isinstance(raw_alphas, list) else [raw_alphas] * len(qs)
                        if len(raw_list) != len(qs):
                            self._send(400, {"error": "alphas length != queries length"})
                            return
                        alphas = []
                        for ra in raw_list:
                            a, err = _parse_alpha(ra)
                            if err:
                                self._send(400, {"error": err})
                                return
                            alphas.append(a)
                    pairs = list(zip(qs, alphas))
                elif "query" in payload:
                    a, err = _parse_alpha(payload.get("alpha"))
                    if err:
                        self._send(400, {"error": err})
                        return
                    pairs = [(payload["query"], a)]
                else:
                    self._send(400, {"error": "body needs 'query' or 'queries'"})
                    return
                # hard filters / candidate constraints: these requests carry
                # their own corpus subset, so they bypass the shared
                # MicroBatcher AND the result cache (a mask is not part of
                # the cache key) — the request's own queries still ride one
                # masked search
                allow = payload.get("allow_uuids")
                deny = payload.get("deny_uuids")
                cands = payload.get("candidates")
                fused = payload.get("fused", False)
                if cands is not None and (allow is not None or deny is not None):
                    self._send(400, {"error": "candidates and allow/deny_uuids are exclusive"})
                    return
                if fused and (cands is not None or allow is not None or deny is not None):
                    self._send(400, {"error": "fused is exclusive with filters/candidates"})
                    return
                if fused:
                    # learned-head rescoring: a different scoring path from
                    # the shared blend batch, so it bypasses the MicroBatcher
                    # and the (query, alpha)-keyed result cache
                    if fused_batch_fn is None:
                        self._send(501, {"error": "fused search not enabled (no fusion head wired)"})
                        return
                    try:
                        out = fused_batch_fn([q for q, _ in pairs], [a for _, a in pairs])
                        out = [r[:n] for r in out]
                    except Exception as e:
                        self._send(502, {"error": str(e)})
                        return
                    if "queries" in payload:
                        self._send(200, {"queries": payload["queries"], "results": out})
                    else:
                        self._send(200, {"query": payload["query"], "results": out[0]})
                    return
                for name, v in (("allow_uuids", allow), ("deny_uuids", deny)):
                    if v is not None and (not isinstance(v, list) or not all(isinstance(u, str) for u in v)):
                        self._send(400, {"error": f"{name} must be a list of uuid strings"})
                        return
                if allow is not None or deny is not None:
                    if filtered_batch_fn is None:
                        self._send(501, {"error": "filtered search not enabled"})
                        return
                    try:
                        out = filtered_batch_fn(
                            [q for q, _ in pairs], [a for _, a in pairs], allow, deny
                        )
                        out = [r[:n] for r in out]
                    except ValueError as e:  # e.g. ann='ivf' backend
                        self._send(400, {"error": str(e)})
                        return
                    except Exception as e:
                        self._send(502, {"error": str(e)})
                        return
                    if "queries" in payload:
                        self._send(200, {"queries": payload["queries"], "results": out})
                    else:
                        self._send(200, {"query": payload["query"], "results": out[0]})
                    return
                if cands is not None:
                    if candidates_batch_fn is None:
                        self._send(501, {"error": "candidate scoring not enabled"})
                        return
                    if "query" in payload and cands and isinstance(cands[0], str):
                        cands = [cands]  # single-query form: one flat list
                    if len(cands) != len(pairs) or not all(
                        isinstance(c, list) and all(isinstance(u, str) for u in c)
                        for c in cands
                    ):
                        self._send(400, {"error": "candidates must be one uuid list per query"})
                        return
                    try:
                        out = candidates_batch_fn(
                            [q for q, _ in pairs], cands, [a for _, a in pairs]
                        )
                        out = [r[:n] for r in out]
                    except ValueError as e:
                        self._send(400, {"error": str(e)})
                        return
                    except Exception as e:
                        self._send(502, {"error": str(e)})
                        return
                    if "queries" in payload:
                        self._send(200, {"queries": payload["queries"], "results": out})
                    else:
                        self._send(200, {"query": payload["query"], "results": out[0]})
                    return
                try:
                    futs = [submit_query(q, a) for q, a in pairs]
                    out = [f.result()[:n] for f in futs]
                except Overloaded as e:
                    self._send(503, {"error": str(e)})
                    return
                except _AlphaNotEnabled as e:
                    self._send(400, {"error": str(e)})
                    return
                except Exception as e:  # backend failure via the futures
                    self._send(502, {"error": str(e)})
                    return
                if "queries" in payload:
                    self._send(200, {"queries": payload["queries"], "results": out})
                else:
                    self._send(200, {"query": payload["query"], "results": out[0]})

        # stdlib default accept backlog is 5 — concurrent clients without
        # keep-alive reconnect per request and overflow it into connection
        # resets (measured: 32 callers -> 1-2% ECONNRESET). 128 covers any
        # sane caller count; the MicroBatcher provides the real backpressure
        # (max_pending -> 503), not the accept queue.
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self._httpd = _Server((host, port), Handler)
        self._thread: Optional[threading.Thread] = None
        self._serving = False
        self._closed = False
        self._close_lock = threading.Lock()

    @property
    def address(self) -> tuple:
        return self._httpd.server_address

    def serve_forever(self) -> None:
        self._serving = True
        self._httpd.serve_forever()

    def request_shutdown(self) -> None:
        """Ask a running :meth:`serve_forever` to return (safe from a signal
        handler's helper thread). The FULL teardown — socket close, batcher
        drain — must then run on the foreground thread via :meth:`close`:
        doing it all on a daemon helper races process exit, which would kill
        the drain mid-flight the moment the main thread returns."""
        self._httpd.shutdown()

    def start(self) -> "RetrievalHTTPServer":
        """Serve on a background thread (for tests / embedding)."""
        self._serving = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="kemr-http"
        )
        self._thread.start()
        return self

    def close(self) -> None:
        # idempotent: a SIGTERM handler and the post-serve_forever path may
        # both call it; only the first does the work
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        # shutdown() blocks on an event only serve_forever() ever sets —
        # calling it on a server that never served would deadlock forever.
        if self._serving:
            self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join()
        self.batcher.close()
        if self.image_batcher is not None:
            self.image_batcher.close()

    def __enter__(self) -> "RetrievalHTTPServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
