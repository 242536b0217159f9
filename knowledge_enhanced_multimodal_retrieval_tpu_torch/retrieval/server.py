"""Micro-batching request aggregator for serving.

The port's copy of ``knowledge_enhanced_multimodal_retrieval_tpu/retrieval/server.py``
(pure host code). The search pays its encoder and scan launches once per
batch, so concurrent callers should share batches: requests are collected
for up to ``max_wait_ms`` (or until ``max_batch``), dispatched as ONE batch,
and each caller's future resolves with its own results.

One repair against the original: the counters and the batch-size histogram
are written under the lock and :attr:`MicroBatcher.stats` reads them under
it, so a batch size seen for the first time during a ``stats`` call cannot
break the iteration.

Usage::

    batcher = MicroBatcher(engine.retrieve_text_noknowledge_batch)
    fut = batcher.submit("a red vase")       # from any thread
    results = fut.result()
    # or blocking: batcher.retrieve("a red vase")
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence


class Overloaded(RuntimeError):
    """Raised by :meth:`MicroBatcher.submit` when load-shedding
    (``max_pending`` reached); HTTP maps it to 503."""


class MicroBatcher:
    """Aggregates concurrent single-query requests into device batches.

    ``batch_fn``: ``Sequence[str] -> List[List[dict]]`` — any batched
    retrieval entry point (``RetrievalEngine.retrieve_text_batch``,
    ``retrieve_text_noknowledge_batch``, ``CLIPRetrieval.retrieval_batch``).
    Per-request knobs (alpha, k) are fixed per batcher instance — bind them
    into ``batch_fn`` with ``functools.partial``.
    """

    def __init__(
        self,
        batch_fn: Callable[[Sequence[str]], List[List[dict]]],
        max_batch: int = 256,
        max_wait_ms: float = 2.0,
        pad_to_bucket: bool = True,
        max_pending: int = 0,
        length_bucket_fn: Optional[Callable[[str], int]] = None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._batch_fn = batch_fn
        self._max_batch = max_batch
        self._max_wait_s = max_wait_ms / 1e3
        # Sequence-length bucketing (opt-in): encode cost is linear in the
        # batch's LONGEST query's seq bucket, so one long query makes every
        # short query in its micro-batch pay the wide bucket. With a
        # ``length_bucket_fn`` (query -> seq bucket, e.g.
        # ``CLIPRetrieval.seq_bucket``), each micro-batch splits into
        # per-bucket groups dispatched separately — short queries keep
        # their cheap encode. Warmup's (batch, seq-bucket) grid covers
        # the extra shapes.
        self._bucket_fn = length_bucket_fn
        # Backpressure: with max_pending > 0, submit() raises Overloaded once
        # that many requests are queued/in flight instead of letting latency
        # grow without bound (load-shed at admission, not after queueing).
        self._max_pending = max_pending
        self._pending = 0
        # Pad the query list to the next power of two (echoing the last
        # query) and slice results back: the JAX package's default, which
        # bounds its compiles per batch shape. The eager port compiles
        # nothing per shape, so the padded rows are encoder work only; the
        # default is kept so that both packages dispatch the same batches.
        self._pad_to_bucket = pad_to_bucket
        self._queue: "queue_mod.Queue" = queue_mod.Queue()
        self._closed = False
        # orders submit() vs close()'s sentinel, and guards every counter
        self._lock = threading.Lock()
        self._batches = 0  # dispatched batches (observability/tests)
        self._served = 0  # total queries served
        self._rejected = 0  # load-shed submissions
        # dispatched-batch size histogram: real (unpadded) size -> count;
        # shows how well concurrent load aggregates into device batches
        self._batch_size_hist: Dict[int, int] = {}
        # ring of recent end-to-end request latencies (submit -> resolve), s
        self._latencies: List[float] = []
        self._lat_cap = 2048
        self._worker = threading.Thread(target=self._run, daemon=True, name="kemr-microbatch")
        self._worker.start()

    # -- client API -----------------------------------------------------------

    def submit(self, query: str) -> Future:
        """Enqueue one query; the Future resolves to its result list."""
        fut: Future = Future()
        # The closed-check and the put must be atomic vs close(): otherwise a
        # request can land BEHIND the shutdown sentinel and its future would
        # never resolve (the caller blocks forever).
        with self._lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            if self._max_pending and self._pending >= self._max_pending:
                self._rejected += 1
                raise Overloaded(
                    f"{self._pending} requests pending (limit {self._max_pending})"
                )
            self._pending += 1
            self._queue.put((query, fut, time.monotonic()))
        return fut

    def retrieve(self, query: str, timeout: Optional[float] = None) -> List[dict]:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(query).result(timeout=timeout)

    @property
    def stats(self) -> dict:
        with self._lock:  # one snapshot: the worker writes these under the lock
            out = {
                "batches": self._batches,
                "served": self._served,
                "rejected": self._rejected,
                "pending": self._pending,
                "batch_size_hist": dict(sorted(self._batch_size_hist.items())),
            }
            lats = sorted(self._latencies)
        if lats:
            q = lambda p: lats[min(len(lats) - 1, int(p * len(lats)))]  # noqa: E731
            out["latency_ms"] = {
                "p50": round(q(0.50) * 1e3, 3),
                "p95": round(q(0.95) * 1e3, 3),
                "p99": round(q(0.99) * 1e3, 3),
                "n": len(lats),
            }
        return out

    def close(self) -> None:
        """Stop accepting work, drain what's queued, join the worker."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # wake the worker
        self._worker.join()
        # Fail any future that slipped in behind the sentinel (none can,
        # post-lock, but drain defensively) so no caller blocks forever.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue_mod.Empty:
                break
            if item is not None:
                if item[1].set_running_or_notify_cancel():
                    item[1].set_exception(RuntimeError("MicroBatcher is closed"))
                self._finish()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker ---------------------------------------------------------------

    def _next_batch(self) -> Optional[list]:
        """Block for the first request, then drain until max_batch/deadline."""
        first = self._queue.get()
        if first is None:
            return None
        items = [first]
        deadline = time.monotonic() + self._max_wait_s
        while len(items) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._queue.get(timeout=remaining)
            except queue_mod.Empty:
                break
            if item is None:
                self._queue.put(None)  # re-post the shutdown signal
                break
            items.append(item)
        return items

    def _finish(self, t0: Optional[float] = None) -> None:
        """One request left the system; record its end-to-end latency."""
        with self._lock:
            self._pending -= 1
            if t0 is not None:
                self._latencies.append(time.monotonic() - t0)
                if len(self._latencies) > self._lat_cap:
                    del self._latencies[: len(self._latencies) - self._lat_cap]

    def _run(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            # Claim each future; a caller that already cancelled (client gave
            # up) is dropped here — resolving a cancelled Future would raise
            # InvalidStateError and kill this worker thread for good.
            items = []
            for it in batch:
                if it[1].set_running_or_notify_cancel():
                    items.append(it)
                else:
                    self._finish()
            if not items:
                continue
            for group in self._length_groups(items):
                self._dispatch(group)

    def _length_groups(self, items: list) -> list:
        """Split a micro-batch into per-seq-bucket groups (identity without
        a ``length_bucket_fn``). Bucket-fn failures (e.g. a query the
        tokenizer rejects) fall into one shared group so the error surfaces
        per-request from ``batch_fn``, not by killing the worker."""
        if self._bucket_fn is None:
            return [items]
        groups: dict = {}
        for it in items:
            try:
                b = self._bucket_fn(it[0])
            except BaseException:
                b = -1
            groups.setdefault(b, []).append(it)
        # widest bucket first: the expensive group runs while
        # the cheap ones queue behind it, minimizing the slowest caller's wait
        return [groups[b] for b in sorted(groups, reverse=True)]

    def _dispatch(self, items: list) -> None:
        queries = [q for q, _, _ in items]
        n = len(queries)
        if self._pad_to_bucket and n < self._max_batch:
            bucket = 1 << (n - 1).bit_length()  # next power of two
            queries = queries + [queries[-1]] * (min(bucket, self._max_batch) - n)
        try:
            results = self._batch_fn(queries)
            if len(results) != len(queries):
                raise RuntimeError(
                    f"batch_fn returned {len(results)} results for {len(queries)} queries"
                )
            results = results[:n]
        except BaseException as e:
            for _, fut, t0 in items:
                fut.set_exception(e)
                self._finish(t0)
            return
        with self._lock:
            self._batches += 1
            self._served += len(items)
            self._batch_size_hist[n] = self._batch_size_hist.get(n, 0) + 1
        for (_, fut, t0), res in zip(items, results):
            fut.set_result(res)
            self._finish(t0)
