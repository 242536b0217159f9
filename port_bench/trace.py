"""Spans the harness puts around the program's calls, and the reduction of a
profiler trace to device time by span, busy time, the top device
operations and the device's idle gaps by what the host was doing.

A span wraps a callable: it adds the call's host seconds to its name and,
while the profiler records, opens a ``record_function`` of the same name
(prefixed ``pb:``), so that every device operation launched inside it can
be charged to it. Spans nest: an operation counts for every span open
around its launch.
"""

from __future__ import annotations

import bisect
import functools
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

PREFIX = "pb:"


class Spans:
    def __init__(self):
        self.profiling = False  # True while the profiler records: open a ``record_function`` too
        self.host: Dict[str, List[float]] = defaultdict(list)  # seconds of each call
        self.calls: Dict[str, List[object]] = defaultdict(list)  # what ``info`` kept of each call

    def reset(self) -> None:
        self.host.clear()
        self.calls.clear()

    def wrap(self, fn: Callable, name: str, info: Optional[Callable] = None) -> Callable:
        """``fn`` with a span ``name``; ``info(args, kwargs, result)`` may
        return something to keep for each call (a shape)."""
        spans = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            if spans.profiling:
                with torch.profiler.record_function(PREFIX + name):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            spans.host[name].append(time.perf_counter() - t0)
            if info is not None:
                spans.calls[name].append(info(args, kwargs, out))
            return out

        return wrapper


class Patches:
    """Attributes set for a while and put back: the spans installed on the
    program's modules and objects."""

    def __init__(self):
        self._saved: List[Tuple[object, str, object, bool]] = []

    def set(self, owner, attr: str, value) -> None:
        had = attr in vars(owner) if hasattr(owner, "__dict__") else True
        self._saved.append((owner, attr, getattr(owner, attr, None), had))
        setattr(owner, attr, value)

    def wrap(self, spans: Spans, owner, attr: str, name: str, info: Optional[Callable] = None) -> None:
        self.set(owner, attr, spans.wrap(getattr(owner, attr), name, info))

    def restore(self) -> None:
        for owner, attr, old, had in reversed(self._saved):
            if had:
                setattr(owner, attr, old)
            else:
                delattr(owner, attr)
        self._saved.clear()


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------


class Event:
    """One event of the trace, in nanoseconds: a device operation (a kernel,
    a copy or a fill: ``device=True``), a host span (a ``pb:`` annotation),
    a launch (``launch=True``) or another host operator."""

    __slots__ = ("name", "start", "end", "device", "corr", "linked", "thread", "launch")

    def __init__(self, name: str, start: int, end: int, device: bool, corr: int = 0, linked: int = 0,
                 thread: int = 0, launch: bool = False):
        self.name, self.start, self.end, self.device = name, start, end, device
        self.corr, self.linked, self.thread, self.launch = corr, linked, thread, launch


def _is_launch(on_device: bool, name: str) -> bool:
    """A host call of the CUDA runtime or driver (``cudaLaunchKernel``,
    ``cuLaunchKernelEx``, ``cudaMemcpyAsync``...)."""
    return not on_device and name.startswith("cu")


def events_from_profiler(prof) -> List[Event]:
    """The kineto events of a finished ``torch.profiler.profile``. The
    device's copy of a host annotation (a ``record_function`` range drawn
    on the device's timeline: it bears the host range's name) is no
    operation and is left out."""
    raw = list(prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    host_names = {e.name() for e in raw if e.device_type() == cpu and not _is_launch(False, e.name())}
    out = []
    for e in raw:
        on_device = e.device_type() != cpu
        if on_device and (e.name() in host_names or e.name().startswith(PREFIX)):
            continue
        out.append(Event(e.name(), e.start_ns(), e.end_ns(), on_device, e.correlation_id(),
                         e.linked_correlation_id(), e.start_thread_id(), _is_launch(on_device, e.name())))
    return out


def _merge(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(spans: Sequence[Tuple[int, int, str]], w0: int, w1: int) -> List[Tuple[int, int, str]]:
    """One thread's nested spans (sorted by start) as a gapless timeline of
    ``(start, end, name)`` from ``w0`` to ``w1``: the innermost open span,
    or "no span"."""
    marks = sorted({w0, w1, *(max(w0, min(w1, t)) for s, e, _ in spans for t in (s, e))})
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for a, b in zip(marks, marks[1:]):
        while i < len(spans) and spans[i][0] <= a:
            stack.append(spans[i])
            i += 1
        stack = [x for x in stack if x[1] > a]
        name = stack[-1][2] if stack else "no span"
        if out and out[-1][2] == name and out[-1][1] == a:
            out[-1] = (out[-1][0], b, name)
        else:
            out.append((a, b, name))
    return out


class Reduction:
    """What the metrics read of one traced window."""

    def __init__(self, events: Sequence[Event], window: str = "window"):
        spans = [e for e in events if not e.device and e.name.startswith(PREFIX)]
        win = [e for e in spans if e.name == PREFIX + window]
        if not win:
            raise ValueError("the trace has no window span")
        w0, w1 = win[0].start, win[0].end
        self.window_s = (w1 - w0) / 1e9
        dev = [e for e in events if e.device and e.end > w0 and e.start < w1]
        # a device operation's host side: the runtime call with its correlation
        # id, else the operator or annotation it is linked to
        launches = {e.corr: e for e in events if e.launch and e.corr}
        frontend = {e.corr: e for e in events if not e.device and not e.launch and e.corr}
        # the spans open on each thread, as (start, end, name) sorted by start
        by_thread: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
        for e in spans:
            if e.name != PREFIX + window:
                by_thread[e.thread].append((e.start, e.end, e.name[len(PREFIX):]))
        for v in by_thread.values():
            v.sort()
        starts = {t: [s for s, _, _ in v] for t, v in by_thread.items()}

        def open_at(thread: int, t: int) -> List[str]:
            v = by_thread.get(thread, [])
            i = bisect.bisect_right(starts.get(thread, []), t)
            return [name for s, e, name in v[max(0, i - 64):i] if e >= t]

        self.device_s: Dict[str, float] = defaultdict(float)  # device seconds launched inside each span
        self.device_ops: Dict[str, float] = defaultdict(float)
        self.kernels_by_span: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        for e in dev:
            d = (min(e.end, w1) - max(e.start, w0)) / 1e9
            self.device_ops[e.name] += d
            launch = launches.get(e.corr) or frontend.get(e.linked)
            if launch is None:
                continue
            for name in set(open_at(launch.thread, launch.start)):
                self.device_s[name] += d
                self.kernels_by_span[name][e.name] += d
        busy = _merge([(max(e.start, w0), min(e.end, w1)) for e in dev])
        self.busy_s = sum(e - s for s, e in busy) / 1e9
        self.n_device_ops = len(dev)
        # idle gaps, split by what the host's busiest thread was doing: the
        # innermost span open at each instant of the gap, else "no span"
        gaps: Dict[str, float] = defaultdict(float)
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        main = max(by_thread, key=lambda t: len(by_thread[t]), default=None)
        segments = _innermost(by_thread.get(main, []), w0, w1)
        k = 0
        for s, e in zip(edges[::2], edges[1::2]):
            while k < len(segments) and segments[k][1] <= s:
                k += 1
            j = k
            while s < e:
                if j < len(segments) and segments[j][0] < e:
                    a, b, name = segments[j]
                    gaps[name] += (min(b, e) - max(a, s)) / 1e9 if b > s else 0.0
                    s = max(s, min(b, e))
                    j += 1
                else:
                    gaps["no span"] += (e - s) / 1e9
                    s = e
        self.idle_gaps = dict(gaps)

    def top_ops(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.idle_gaps.items(), key=lambda kv: -kv[1])[:n]]
