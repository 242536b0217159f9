"""Circuit breaker for the knowledge retriever — fast-fail when the KG is down.

The reference calls its LLM agent and SPARQL endpoint inline with no seam
(``src/text2sparql/text2sparql_retrieval.py:30-58``); when either is hard
down, EVERY query pays the full network timeout before degrading. This
wrapper implements the standard three-state breaker around any retriever
exposing ``retrieval(query) -> list``:

- **CLOSED** (normal): calls pass through; consecutive failures count up.
- **OPEN**: after ``failure_threshold`` consecutive failures, calls
  fast-fail to the empty result (the engine then serves CLIP-only —
  identical to the reference's per-query degradation, minus the timeout)
  until ``cooldown_s`` elapses.
- **HALF-OPEN**: one trial call is let through; success closes the
  circuit, failure re-opens it for another cooldown.

Thread-safe (the engine fans batch queries over a thread pool). The inner
retriever must RAISE on failure (``Text2SparqlRetrieval(raise_errors=
True)``) — a swallowed error is indistinguishable from a legitimate empty
result and would never trip the breaker.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List

from ..utils.logging_utils import setup_logger

logger = setup_logger("kemr_torch.knowledge.circuit")

_CLOSED, _OPEN, _HALF_OPEN = "closed", "open", "half-open"


class KnowledgeUnavailable(RuntimeError):
    """Raised (opt-in) by the breaker instead of returning the degraded
    empty result — lets wrappers (the cache) distinguish 'the KG said
    nothing matches' from 'the KG is down right now'."""


class CachedRetrieval:
    """TTL'd LRU cache in front of a retriever — popular queries skip the
    LLM + KG round trips entirely.

    The engine already dedupes WITHIN one batch; this carries results
    ACROSS batches (real traffic repeats popular queries; each miss costs
    seconds of agent latency). Entries expire after ``ttl_s`` so KG updates
    eventually surface; LEGITIMATE empty results are cached too (a query
    the KG cannot answer stays expensive to re-ask). Composes outside a
    breaker built with ``raise_on_degrade=True``: a degraded answer (the
    endpoint is down) raises :class:`KnowledgeUnavailable`, which this
    cache converts to the engine-compatible ``[]`` WITHOUT caching it —
    otherwise a one-minute KG blip would pin popular queries to empty
    knowledge for the whole TTL. Thread-safe.
    """

    def __init__(
        self,
        inner,
        maxsize: int = 2048,
        ttl_s: float = 300.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        if ttl_s <= 0:
            raise ValueError(f"ttl_s must be > 0, got {ttl_s}")
        from collections import OrderedDict

        self.inner = inner
        self.maxsize = maxsize
        self.ttl_s = ttl_s
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, tuple]" = OrderedDict()
        self._hits = 0
        self._misses = 0

    @property
    def stats(self) -> dict:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses, "size": len(self._entries)}

    def invalidate(self) -> None:
        """Drop every entry (call after known KG mutations)."""
        with self._lock:
            self._entries.clear()

    def retrieval(self, query: str) -> List[str]:
        now = self._clock()
        with self._lock:
            hit = self._entries.get(query)
            if hit is not None and now - hit[0] < self.ttl_s:
                self._entries.move_to_end(query)
                self._hits += 1
                return list(hit[1])
            self._misses += 1
        try:
            result = self.inner.retrieval(query)
        except KnowledgeUnavailable:
            return []  # degraded, NOT cached — re-asked once the KG is back
        with self._lock:
            self._entries[query] = (now, list(result))
            self._entries.move_to_end(query)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
        return result


class CircuitBreakerRetrieval:
    """Breaker-wrapped retriever; duck-types ``retrieval`` for the engine."""

    def __init__(
        self,
        inner,
        failure_threshold: int = 5,
        cooldown_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        raise_on_degrade: bool = False,
    ):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, got {failure_threshold}")
        if cooldown_s <= 0:
            raise ValueError(f"cooldown_s must be > 0, got {cooldown_s}")
        self.inner = inner
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        # False (engine-compatible): degrade to []. True: raise
        # KnowledgeUnavailable so a wrapping cache never stores the
        # degraded empty as if the KG had answered.
        self.raise_on_degrade = raise_on_degrade
        self._clock = clock
        self._lock = threading.Lock()
        self._state = _CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self._trial_in_flight = False
        # observability counters (exposed via .stats)
        self._fast_fails = 0
        self._trips = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state()

    @property
    def stats(self) -> dict:
        with self._lock:
            return {
                "state": self._effective_state(),
                "consecutive_failures": self._failures,
                "fast_fails": self._fast_fails,
                "trips": self._trips,
            }

    def _effective_state(self) -> str:
        if self._state == _OPEN and self._clock() - self._opened_at >= self.cooldown_s:
            return _HALF_OPEN
        return self._state

    def retrieval(self, query: str) -> List[str]:
        with self._lock:
            state = self._effective_state()
            if state == _OPEN or (state == _HALF_OPEN and self._trial_in_flight):
                # fast-fail: no network round trip, engine serves CLIP-only
                self._fast_fails += 1
                if self.raise_on_degrade:
                    raise KnowledgeUnavailable("knowledge circuit open")
                return []
            trial = state == _HALF_OPEN
            if trial:
                self._trial_in_flight = True
        try:
            result = self.inner.retrieval(query)
        except Exception as e:
            with self._lock:
                if trial:
                    self._trial_in_flight = False
                self._failures += 1
                # a failed half-open trial re-opens (fresh cooldown); a
                # closed circuit opens once the threshold is crossed
                if trial or (
                    self._state == _CLOSED and self._failures >= self.failure_threshold
                ):
                    self._state = _OPEN
                    self._opened_at = self._clock()
                    self._trips += 1
                    logger.warning(
                        "knowledge circuit OPEN after %d failure(s): %s "
                        "(fast-failing for %.0fs)",
                        self._failures, e, self.cooldown_s,
                    )
                else:
                    logger.warning("knowledge retrieval failed (%d/%d): %s",
                                   self._failures, self.failure_threshold, e)
            if self.raise_on_degrade:
                raise KnowledgeUnavailable(str(e)) from e
            return []
        with self._lock:
            if trial:
                self._trial_in_flight = False
                logger.info("knowledge circuit CLOSED (trial call succeeded)")
            # only a trial success (or a success while still closed) closes
            # the circuit: a slow straggler admitted BEFORE the trip must not
            # re-close an OPEN circuit mid-outage and defeat the cooldown
            if trial or self._state == _CLOSED:
                self._state = _CLOSED
                self._failures = 0
        return result
