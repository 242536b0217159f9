"""A cell's run with the program's own spans and counters read: the
port's recorder (``utils.profiling``) on for the whole run, its set-up and
each window snapshotted, and the traced window's idle gaps charged to the
innermost span open on the host, the program's ``kemr:`` spans as well as
the harness's ``pb:`` ones.

    python3 port_bench/program_trace.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The run is ``port_bench/run.py``'s, and so is its result line; with
``--trace 1`` the line adds the metrics of :data:`METRICS` that list the
cell, ``breakdown.idle_gaps`` names program spans, ``breakdown.program_device``
gives the device seconds launched inside each program span, and
``program`` holds the set-up's and the measured window's span totals and
counters and every idle gap. With ``--trace 0``, or a program without the recorder, the run and
its line are ``run.py``'s exactly.

``run.py`` does none of this yet. This file is the stand-in until it does:
wiring it in means ``harness.measure`` taking :func:`measure`'s recorder
steps, ``trace.Reduction`` taking :class:`ProgramReduction`'s device time
and gap split (and :class:`Nest` in place of its fixed look-back), an entry
in ``BENCHMARK.json`` and a reader under ``port_bench/metrics/`` for each of
:data:`METRICS`; then this file goes.
"""

from __future__ import annotations

import bisect
import importlib
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

if __name__ == "__main__":
    T_START = time.perf_counter()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from port_bench import harness
from port_bench import trace as tr

PROGRAM = "kemr:"  # the prefix of the program's spans in a trace (``utils.profiling.PREFIX``)
HARNESS_MEASURE = harness.measure


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        mod = importlib.import_module("knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.profiling")
    except ImportError:
        return None
    need = ("enable", "reset", "snapshot", "span")
    return mod if all(hasattr(mod, n) for n in need) else None


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------


class ProgramReduction(tr.Reduction):
    """``trace.Reduction`` (every number of it read from the ``pb:`` spans
    alone, as before) with ``program_device_s``, the device seconds of the
    operations launched inside each ``kemr:`` span, and ``idle_gaps`` split
    by the innermost span of either prefix open on the main thread (the
    thread with the most ``pb:`` spans). Program spans keep their prefix in
    the gaps' names. A trace with no ``kemr:`` event reduces exactly as
    ``trace.Reduction`` does."""

    def __init__(self, events: Sequence[tr.Event], window: str = "window"):
        super().__init__(events, window)
        self.program_device_s: Dict[str, float] = {}
        prog = [e for e in events if not e.device and e.name.startswith(PROGRAM)]
        if not prog:
            return
        pb = [e for e in events if not e.device and e.name.startswith(tr.PREFIX) and e.name != tr.PREFIX + window]
        w = next(e for e in events if not e.device and e.name == tr.PREFIX + window)
        w0, w1 = w.start, w.end
        dev = [e for e in events if e.device and e.end > w0 and e.start < w1]
        launches = {e.corr: e for e in events if e.launch and e.corr}
        frontend = {e.corr: e for e in events if not e.device and not e.launch and e.corr}
        spans = by_thread(prog, keep_prefix=True)
        nests = {t: Nest(v) for t, v in spans.items()}
        device_s: Dict[str, float] = defaultdict(float)
        for e in dev:
            launch = launches.get(e.corr) or frontend.get(e.linked)
            if launch is None or launch.thread not in nests:
                continue
            d = (min(e.end, w1) - max(e.start, w0)) / 1e9
            for name in set(nests[launch.thread].open_at(launch.start)):
                device_s[name[len(PROGRAM):]] += d
        self.program_device_s = dict(device_s)
        harness_spans = by_thread(pb, keep_prefix=False)
        main = max(harness_spans, key=lambda t: len(harness_spans[t]), default=None)
        if main is None:
            main = max(spans, key=lambda t: len(spans[t]))
        # the outer of two spans that start together first: the later one pushed is the innermost
        both = sorted(harness_spans.get(main, []) + spans.get(main, []), key=lambda x: (x[0], -x[1]))
        busy = tr._merge([(max(e.start, w0), min(e.end, w1)) for e in dev])
        self.idle_gaps = split_gaps(both, busy, w0, w1)

    def top_program_device(self, n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(self.program_device_s.items(), key=lambda kv: -kv[1])[:n]]


def by_thread(spans: Sequence[tr.Event], keep_prefix: bool) -> Dict[int, List[Tuple[int, int, str]]]:
    """Host spans as ``(start, end, name)`` by thread, sorted by start, the
    outer of two that start together first; a ``pb:`` span's name without
    its prefix."""
    out: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    for e in spans:
        out[e.thread].append((e.start, e.end, e.name if keep_prefix else e.name[len(tr.PREFIX):]))
    for v in out.values():
        v.sort(key=lambda x: (x[0], -x[1]))
    return out


class Nest:
    """One thread's spans (as :func:`by_thread` sorts them) with each one's
    parent, the innermost span still open where it starts. The spans open
    at an instant lie on the parent chain of the last span started by then,
    however many spans started before it."""

    def __init__(self, spans: Sequence[Tuple[int, int, str]]):
        self.spans, self.starts, self.parent = spans, [s for s, _, _ in spans], []
        stack: List[int] = []
        for i, (s, _, _) in enumerate(spans):
            while stack and spans[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def open_at(self, t: int) -> List[str]:
        """The names of the spans open at ``t`` (start <= t <= end), innermost first."""
        out, i = [], bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            if self.spans[i][1] >= t:
                out.append(self.spans[i][2])
            i = self.parent[i]
        return out


def split_gaps(spans: Sequence[Tuple[int, int, str]], busy: Sequence[Tuple[int, int]], w0: int, w1: int
               ) -> Dict[str, float]:
    """Seconds of each idle gap of the window (between the ``busy``
    intervals) by the innermost of one thread's ``spans`` open then, else
    "no span"."""
    gaps: Dict[str, float] = defaultdict(float)
    segments = tr._innermost(spans, w0, w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    k = 0
    for s, e in zip(edges[::2], edges[1::2]):
        while k < len(segments) and segments[k][1] <= s:
            k += 1
        for a, b, name in segments[k:]:
            if a >= e:
                break
            if b > s:
                gaps[name] += (min(b, e) - max(a, s)) / 1e9
    return dict(gaps)


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------


def measure(run, t_start: float) -> None:
    """``harness.measure`` with the recorder on throughout: a snapshot of
    set-up (``run.program_setup``, taken as the first window opens) and of
    each window from a reset at its start (``Window.program``); the traced
    window reduced by :class:`ProgramReduction`."""
    rec = recorder()
    plain_window = run.window

    def window(seconds: float, check: bool):
        if not hasattr(run, "program_setup"):
            run.program_setup = rec.snapshot()
        rec.reset()
        w = plain_window(seconds, check)
        w.program = rec.snapshot()
        return w

    run.window = window
    tr.Reduction = ProgramReduction
    rec.reset()
    rec.enable(True)
    try:
        HARNESS_MEASURE(run, t_start)
    finally:
        rec.enable(False)
        tr.Reduction = ProgramReduction.__base__
        del run.window


def _span_ms(w, name: str, unit: str) -> Optional[float]:
    """Host ms of the span ``name`` a batch or step of window ``w``."""
    n = w.counts.get(unit, 0)
    spans = getattr(w, "program", {}).get("spans", {})
    if not n or name not in spans:
        return None
    return spans[name]["total_ns"] / n / 1e6


def _bpe_miss_share(run) -> Optional[float]:
    c = getattr(run.plain, "program", {}).get("counters", {})
    if not c.get("tokenizer.words"):
        return None
    return 100.0 * c.get("tokenizer.bpe_misses", 0) / c["tokenizer.words"]


def _corpus_install_s(run) -> Optional[float]:
    spans = (getattr(run, "program_setup", None) or {}).get("spans", {})
    if "retrieval.install_corpus" not in spans:
        return None
    return spans["retrieval.install_corpus"]["total_ns"] / 1e9


SEARCH, TRAIN = ["l14.search.text.1m"], ["l14.train.b128", "l14_336.train.b64"]


def _metric(name, unit, source, layer, moves, cells, read, better="lower"):
    return {"name": name, "unit": unit, "better": better, "source": source, "layer": layer, "moves": moves,
            "workloads": cells, "read": read}


METRICS = [
    _metric("tokenize_host_ms.search", "ms", "program_span", "retriever", "search_qps", SEARCH,
            lambda run: _span_ms(run.plain, "retrieval.tokenize", "batches")),
    _metric("map_host_ms.search", "ms", "program_span", "retriever", "search_qps", SEARCH,
            lambda run: _span_ms(run.plain, "retrieval.map", "batches")),
    _metric("fetch_wait_ms.search", "ms", "program_span", "retriever", "search_qps", SEARCH,
            lambda run: _span_ms(run.plain, "retrieval.fetch", "batches")),
    _metric("bpe_miss_share.search", "%", "program_counter", "retriever", "search_qps", SEARCH, _bpe_miss_share),
    _metric("corpus_install_s.search", "s", "program_span", "retriever", "setup_s", SEARCH, _corpus_install_s),
    _metric("forward_host_ms.train", "ms", "program_span", "trainer", "train_samples_per_s", TRAIN,
            lambda run: _span_ms(run.plain, "train.forward", "steps")),
    _metric("backward_host_ms.train", "ms", "program_span", "trainer", "train_samples_per_s", TRAIN,
            lambda run: _span_ms(run.plain, "train.backward", "steps")),
    _metric("optimizer_host_ms.train", "ms", "program_span", "trainer", "train_samples_per_s", TRAIN,
            lambda run: _span_ms(run.plain, "train.optimizer", "steps")),
    _metric("feed_wait_ms.train", "ms", "program_span", "data", "train_samples_per_s", TRAIN,
            lambda run: _span_ms(run.plain, "train.feed.wait", "steps")),
]
"""Each metric as its ``BENCHMARK.json`` entry would read (less ``read``)."""


def execute(argv=None, root: Optional[Path] = None, require_chip: bool = True, t_start: Optional[float] = None,
            cells: Optional[Dict[str, List[str]]] = None) -> dict:
    """``harness.execute`` with the program's spans read (``--trace 1`` and
    a program with the recorder; else ``harness.execute`` as it is).
    ``cells`` maps a metric to the cells it reads in place of its
    ``workloads`` (the CPU tests' toy cells)."""
    args = harness.parse(argv)
    if not args.trace or recorder() is None:
        return harness.execute(argv, root=root, require_chip=require_chip, t_start=t_start)
    seen = {}

    def measure_and_keep(run, t0):
        seen["run"] = run
        measure(run, t0)

    harness.measure = measure_and_keep
    try:
        result = harness.execute(argv, root=root, require_chip=require_chip, t_start=t_start)
    finally:
        harness.measure = HARNESS_MEASURE
    run = seen["run"]
    added = {}
    for m in METRICS:
        if args.workload not in (cells or {}).get(m["name"], m["workloads"]):
            continue
        v = m["read"](run)
        if v is not None:
            added[m["name"]] = {"value": float(v), "unit": m["unit"]}
    compared = result.pop("compared")
    result["metrics"].update(added)
    result["breakdown"]["program_device"] = run.reduction.top_program_device(20)
    result["program"] = {"setup": run.program_setup, "plain": run.plain.program, "idle_gaps": run.reduction.idle_gaps,
                         "plain_metrics": run.plain.metrics, "plain_counts": run.plain.counts,
                         "plain_window_s": run.plain.window_s}
    result["compared"] = compared
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    try:
        result = execute(argv, t_start=t_start)
    except harness.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
