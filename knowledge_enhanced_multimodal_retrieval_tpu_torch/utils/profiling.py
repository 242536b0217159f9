"""Profiling hooks: the port's span and counter recorder, and traces.

The recorder is off by default. Off, :func:`span` is one test of a module
flag that hands back a shared no-op context manager (no clock read, no
allocation), a function under :func:`spanned` runs after one test of the
same flag, and :func:`count` returns at once. :func:`enable` turns it on:
each span then records its name, start and end, its parent (the span open
around it on the same thread), its thread and an ``id`` (a search batch's
ordinal, a train step's number; a span given none takes its parent's).
While a ``torch.profiler`` session records, an open span also opens
``torch.profiler.record_function("kemr:" + name)``, so the trace carries the
same ranges.

Spans are stamped on the clock of the profiler's host events: Unix time in
nanoseconds in the installed PyTorch. The recorder reads the monotonic clock
and adds the offset between the two, taken once at :func:`enable`, so that a
span lines up with its ``kemr:`` event in the trace.

Finished spans go into a bounded buffer (:func:`finished`) and into
aggregates by name; :func:`snapshot` returns, per name, ``calls``,
``total_ns`` and ``self_ns`` (the total less the time of its children on the
same thread), and the counters. :func:`trace` records a Chrome trace of a
region with the recorder on; :func:`annotate` names a region in a trace.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch

PREFIX = "kemr:"  # the prefix of a span's range in a profiler trace
BUFFER_SPANS = 1 << 16  # finished spans kept, the newest

_ON = False  # the one flag the off path tests


class Span(NamedTuple):
    """A finished span; ``start_ns`` and ``end_ns`` on the profiler's clock."""

    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    thread: int
    id: Optional[int]


class _Off:
    """The context manager every span hands back while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Recorder:
    """Finished spans (the newest ``capacity``), their aggregates by name,
    and the counters. Spans close on several threads at once (the feed's
    worker, the daemon's micro-batch workers), so the aggregates and
    counters change under a lock."""

    def __init__(self, capacity: int = BUFFER_SPANS):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.offset_ns = 0  # the profiler's clock less the monotonic clock
        self.spans: collections.deque = collections.deque(maxlen=capacity)
        self.totals: Dict[str, List[int]] = {}  # name -> [calls, total_ns, self_ns]
        self.counters: Dict[str, int] = {}

    def stack(self) -> list:
        """The spans open on the calling thread, innermost last."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def add(self, span: Span, total_ns: int, self_ns: int) -> None:
        with self._lock:
            self.spans.append(span)
            agg = self.totals.get(span.name)
            if agg is None:
                self.totals[span.name] = [1, total_ns, self_ns]
            else:
                agg[0] += 1
                agg[1] += total_ns
                agg[2] += self_ns

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self.totals.clear()
            self.counters.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {"spans": {n: {"calls": c, "total_ns": t, "self_ns": s} for n, (c, t, s) in self.totals.items()},
                    "counters": dict(self.counters)}


RECORDER = Recorder()


class _On:
    """One span while the recorder is on."""

    __slots__ = ("name", "id", "parent", "t0", "child_ns", "range")

    def __init__(self, name: str, id: Optional[int]):
        self.name, self.id = name, id

    def __enter__(self):
        st = RECORDER.stack()
        self.parent = st[-1] if st else None
        if self.id is None and self.parent is not None:
            self.id = self.parent.id
        self.child_ns = 0
        st.append(self)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        t1 = time.perf_counter_ns()
        st = RECORDER.stack()
        if st and st[-1] is self:
            st.pop()
        total = t1 - self.t0
        parent = self.parent
        if parent is not None:
            parent.child_ns += total
        off = RECORDER.offset_ns
        RECORDER.add(Span(self.name, self.t0 + off, t1 + off, parent.name if parent is not None else None,
                          threading.get_ident(), self.id), total, total - self.child_ns)
        return False


def span(name: str, id: Optional[int] = None):
    """``with span("retrieval.tokenize"): ...``: a span of the recorder (a
    no-op while it is off)."""
    if not _ON:
        return _OFF
    return _On(name, id)


def spanned(name: str):
    """Decorator: every call of the function is a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def in_span(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _On(name, None):
                return fn(*args, **kwargs)

        return in_span

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing while the recorder is off)."""
    if _ON:
        RECORDER.count(name, n)


def enabled() -> bool:
    return _ON


def enable(flag: bool = True) -> None:
    """Turn the recorder on or off; on, take the clock offset anew."""
    global _ON
    if flag:
        RECORDER.offset_ns = time.time_ns() - time.perf_counter_ns()
    _ON = bool(flag)


def reset() -> None:
    """Forget every finished span, aggregate and counter."""
    RECORDER.reset()


def snapshot() -> dict:
    """``{"spans": {name: {"calls", "total_ns", "self_ns"}}, "counters":
    {name: n}}`` since the last :func:`reset`."""
    return RECORDER.snapshot()


def finished() -> List[Span]:
    """The buffer's finished spans, oldest first."""
    with RECORDER._lock:
        return list(RECORDER.spans)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace with the recorder on: ``with trace('profile_dir'):
    step()`` writes ``profile_dir/trace.json`` (load it in Perfetto or
    ``chrome://tracing``); the program's spans are its ``kemr:`` ranges."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was_on = _ON
    enable(True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        enable(was_on)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name a region in the trace timeline."""
    with torch.profiler.record_function(name):
        yield
