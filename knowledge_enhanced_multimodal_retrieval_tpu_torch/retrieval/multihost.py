"""Multi-host sharded serving: one corpus spread over several processes' devices.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/retrieval/multihost.py``,
on ``torch.distributed``. Every process builds the same
``CLIPRetrieval(rt=..., shard_corpus=True)`` over a mesh that spans the
processes (``parallel.mesh``): each stages only its own shards of the same
host-side store, and every search runs the per-shard scans then gathers the
``[Q, k]`` winners from every process (``parallel.sharding.all_gather_processes``),
so all processes must enter each search together and in the same order.

The protocol that guarantees it:

- the **coordinator** (rank 0) owns the request stream: each call to
  :meth:`MultiHostSearch.search_embeddings` broadcasts one fixed-shape work
  item (flag, padded query block, per-query alpha, count) and then every
  process, itself included, runs the sharded search; the merged result is
  the same on every process, so the coordinator returns it at once;
- **followers** run :meth:`MultiHostSearch.serve`: wait for the next
  broadcast, execute, repeat, until the coordinator's :meth:`stop` sentinel
  (flag 0) arrives.

Without ``torch.distributed`` (one process) the broadcast is a copy, so one
deployment script scales from one host to many. The payload's shape is
fixed at construction (``batch`` x store width): the coordinator pads short
blocks and cuts the padding off. Under NCCL the payload crosses on the
rank's card, under gloo as a CPU tensor.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["MultiHostSearch", "MultiHostRetrieval"]


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class MultiHostSearch:
    """Lockstep coordinator / follower wrapper around a sharded retriever.

    ``retrieval`` is a ``CLIPRetrieval`` built identically on every process
    over the same process-spanning mesh (typically ``shard_corpus=True``
    with a packed ``quantize_corpus``). ``batch`` fixes the broadcast
    block's query count; larger searches run as several lockstep steps."""

    _FLAG_STOP = 0
    _FLAG_WORK = 1

    def __init__(self, retrieval, batch: int = 32, stall_timeout_s: float = 120.0):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.r = retrieval
        self.batch = int(batch)
        self.dim = int(np.asarray(retrieval.store.image).shape[1])
        dist = _dist()
        self._proc = dist.get_rank() if dist else 0
        self._stopped = False
        # the daemon's text and image batchers search from two threads; their
        # broadcasts would interleave against the followers' one sequential
        # serve() loop, so every broadcast + execute runs under this lock
        self._lock = threading.Lock()
        # a dead follower leaves the coordinator blocked inside a collective
        # that Python cannot abort; health() reports ok=False once a work
        # item has been in flight past stall_timeout_s (0 disables), and the
        # daemon's /healthz turns that into a 503 for the orchestrator
        self.stall_timeout_s = float(stall_timeout_s)
        self._inflight_since: Optional[float] = None
        self._work_items = 0

    # -- protocol plumbing ------------------------------------------------------

    def _zeros(self) -> Dict[str, np.ndarray]:
        return {
            "flag": np.zeros((), np.int32),
            "q": np.zeros((self.batch, self.dim), np.float32),
            "alpha": np.full((self.batch,), 0.5, np.float32),  # per-query blend
            "count": np.zeros((), np.int32),
        }

    def _broadcast(self, payload: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Rank 0's payload on every rank: one flat f32 tensor ``[flag,
        count, q..., alpha...]`` (the small integers are exact in f32)."""
        dist = _dist()
        if dist is None:
            return {k: np.array(v) for k, v in payload.items()}
        flat = np.concatenate([
            np.array([payload["flag"], payload["count"]], np.float32),
            payload["q"].reshape(-1), payload["alpha"].reshape(-1),
        ])
        dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
        t = torch.from_numpy(flat).to(dev)
        dist.broadcast(t, src=0)
        out = t.cpu().numpy()
        qn = self.batch * self.dim
        return {
            "flag": np.int32(out[0]), "count": np.int32(out[1]),
            "q": out[2:2 + qn].reshape(self.batch, self.dim), "alpha": out[2 + qn:].copy(),
        }

    def _run(self, payload: Dict[str, np.ndarray]) -> List[List[Dict]]:
        count = int(payload["count"])
        # alpha rides as a per-query vector, so scalar and mixed blends share the step
        results = self.r.retrieval_embeddings_batch(payload["q"], alpha=payload["alpha"])
        return results[:count]

    # -- coordinator API --------------------------------------------------------

    @property
    def is_coordinator(self) -> bool:
        return self._proc == 0

    def search_embeddings(self, q_emb, alpha=0.5) -> List[List[Dict]]:
        """Broadcast + execute searches over the sharded corpus
        (coordinator only): ``q_emb`` [Q, D] L2-normalized embeddings (blocks
        of ``batch`` run in turn), ``alpha`` a scalar or one per query.
        Returns one ranked ``[{"uuid", "score"}]`` list per query, as
        ``CLIPRetrieval.retrieval_embeddings_batch`` does."""
        self._require_coordinator("search_embeddings")
        q = q_emb.detach().float().cpu().numpy() if torch.is_tensor(q_emb) else np.asarray(q_emb, np.float32)
        if q.ndim != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be [Q, {self.dim}], got {q.shape}")
        a = np.broadcast_to(np.asarray(alpha, np.float32), (q.shape[0],))
        out: List[List[Dict]] = []
        for lo in range(0, q.shape[0], self.batch):
            block = q[lo:lo + self.batch]
            payload = self._zeros()
            payload["flag"] = np.int32(self._FLAG_WORK)
            payload["q"][: block.shape[0]] = block
            payload["alpha"][: block.shape[0]] = a[lo:lo + block.shape[0]]
            payload["count"] = np.int32(block.shape[0])
            with self._lock:  # one lockstep work item at a time
                if self._stopped:
                    raise RuntimeError("multi-host serving already stopped")
                self._inflight_since = time.monotonic()
                try:
                    out.extend(self._run(self._broadcast(payload)))
                    self._work_items += 1
                finally:
                    self._inflight_since = None
        return out

    # -- failure detection --------------------------------------------------------

    @property
    def stalled(self) -> bool:
        """True when a work item has been in flight longer than
        ``stall_timeout_s``: the signature of a dead or cut-off follower."""
        since = self._inflight_since
        if since is None or self.stall_timeout_s <= 0:
            return False
        return (time.monotonic() - since) > self.stall_timeout_s

    def health(self) -> Dict:
        """Liveness for the daemon's ``/healthz`` (ok=False past the stall
        timeout: HTTP 503, and the orchestrator restarts the job)."""
        since = self._inflight_since
        return {
            "ok": not self.stalled,
            "multihost": {
                "stalled": self.stalled,
                "inflight_s": None if since is None else round(time.monotonic() - since, 1),
                "stall_timeout_s": self.stall_timeout_s,
                "work_items": self._work_items,
                "stopped": self._stopped,
            },
        }

    def search_texts(self, queries, alpha=0.5) -> List[List[Dict]]:
        """Tokenize + encode on the coordinator, then broadcast the
        embeddings (followers never see the query text)."""
        self._require_coordinator("search_texts")
        q = self.r.encode_queries(list(queries)).float().cpu().numpy()
        return self.search_embeddings(q, alpha=alpha)

    def stop(self) -> None:
        """Release every follower's :meth:`serve` loop (idempotent)."""
        self._require_coordinator("stop")
        with self._lock:
            if self._stopped:
                return
            payload = self._zeros()
            payload["flag"] = np.int32(self._FLAG_STOP)
            self._broadcast(payload)
            self._stopped = True

    def _require_coordinator(self, what: str) -> None:
        if not self.is_coordinator:
            raise RuntimeError(
                f"{what} is coordinator-only (process 0); this is process "
                f"{self._proc} — run serve() here instead"
            )

    # -- follower API -----------------------------------------------------------

    def serve(self, max_steps: Optional[int] = None) -> int:
        """Follower loop: execute broadcast work items until the stop
        sentinel (or ``max_steps``); returns the searches served. Every
        process but the coordinator must sit here whenever the coordinator
        may search: a missing follower blocks the collective."""
        if self.is_coordinator:
            raise RuntimeError("the coordinator drives searches; serve() is for followers")
        served = 0
        while max_steps is None or served < max_steps:
            payload = self._broadcast(self._zeros())
            if int(payload["flag"]) == self._FLAG_STOP:
                break
            self._run(payload)
            served += 1
        return served


class MultiHostRetrieval:
    """A ``CLIPRetrieval`` facade for the coordinator that routes every
    device search through the lockstep protocol, so ``RetrievalEngine`` and
    the HTTP daemon's callables serve a multi-host corpus unchanged. Routes
    that would launch a collective the followers do not join (filtered
    search, warmup, the batch streams, fused rescoring) and corpus mutation
    (the followers would not restage) raise ``ValueError`` when called; the
    host-only helpers (tokenizer, preprocessing, candidate rescoring on the
    host store) go to the wrapped retriever."""

    _BLOCKED = (
        "add_documents", "remove_documents", "set_store", "encode_documents",
        "retrieval_filtered", "retrieval_filtered_batch",
        "retrieval_filtered_embeddings_batch", "warmup",
        "search_batch", "search_batches_pipelined", "calibrate_nprobe",
        # batch routes that would launch collectives outside the protocol
        "retrieval_batches", "retrieval_fused_batch",
    )

    def __init__(self, mh: MultiHostSearch):
        self._mh = mh
        self._inner = mh.r

    def retrieval(self, query: str, alpha=0.5, top_k=None) -> List[Dict]:
        return self.retrieval_batch([query], alpha=alpha, top_k=top_k)[0]

    def retrieval_batch(self, queries, alpha=0.5, top_k=None) -> List[List[Dict]]:
        self._check_top_k(top_k)
        return self._mh.search_texts(list(queries), alpha=alpha)

    def retrieval_embeddings_batch(self, q_emb, alpha=0.5, top_k=None) -> List[List[Dict]]:
        self._check_top_k(top_k)
        return self._mh.search_embeddings(q_emb, alpha=alpha)

    def retrieval_image_batch(self, images, alpha=0.5, top_k=None) -> List[List[Dict]]:
        # decoding, preprocessing and the image encode are process-local;
        # only the corpus scan is collective
        q = self._inner.encode_images(self._inner.preprocess_images(images))
        return self.retrieval_embeddings_batch(q, alpha=alpha, top_k=top_k)

    def retrieval_image(self, image, alpha=0.5, top_k=None) -> List[Dict]:
        return self.retrieval_image_batch([image], alpha=alpha, top_k=top_k)[0]

    def stop(self) -> None:
        self._mh.stop()

    def _check_top_k(self, top_k) -> None:
        if top_k is not None and int(top_k) != self._inner.top_k:
            raise ValueError(
                "multi-host serving runs one fixed-k search a work item; construct "
                f"the retriever with top_k={top_k} instead of overriding per call"
            )

    def __getattr__(self, name: str):
        if name in self._BLOCKED:
            # a stub that raises when invoked, not when looked up: the daemon
            # collects its callables at start-up, and ValueError maps to HTTP 400
            def _blocked(*_a, **_k):
                raise ValueError(
                    f"CLIPRetrieval.{name} is not available under multi-host "
                    "serving: it would mutate per-process corpus state or "
                    "launch a collective the follower processes don't know "
                    "to join"
                )

            _blocked.__name__ = f"blocked_{name}"
            return _blocked
        return getattr(self._inner, name)
