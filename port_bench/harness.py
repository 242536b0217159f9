"""The run: find a workload's configuration, traffic mix, limits, runner and
metric readers by name; set up, measure the window, check the outputs
against the reference, and print the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own that this module finds by the name in
``BENCHMARK.json``:

- ``port_bench/configs/<config>.json`` (the ``file`` of the configuration);
- ``port_bench/traffic/<traffic>.json``, whose ``runner`` names a module
  of ``port_bench/runners/`` that runs that kind of traffic;
- ``port_bench/limits/<workload>.json``, the limit of each compared number;
- ``port_bench/metrics/<metric>.py`` with ``read(run) -> float | None``.

Every run measures one window without the profiler, whose counts and host
times give the end-to-end metrics and the host-clock per-layer ones
(``run.plain``). With ``--trace 1`` a second, shorter window of the same
traffic follows under the profiler (``run.traced``, ``run.reduction``):
the device times by span come from it, and nothing read by the host's
clock, since the profiler's record of every operator slows the host.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
TRACED_S = 15.0  # the traced window's length at most: the trace grows with it
FORBIDDEN = ("jax", "jaxlib", "flax", "knowledge_enhanced_multimodal_retrieval_tpu")


class Refused(Exception):
    """The run cannot give a result (no chip, a missing file)."""


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    flax's or the JAX package's, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.exists():
            raise Refused(f"no BENCHMARK.json under {self.root}")
        self.data = json.loads(path.read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise Refused(f"unknown workload {name!r}; known: {[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise Refused(f"unknown configuration {name!r}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "port_bench" / "traffic" / f"{name}.json").read_text())

    def limits(self, workload: str) -> dict:
        return json.loads((self.root / "port_bench" / "limits" / f"{workload}.json").read_text())

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload: str) -> List[dict]:
        """The per-layer metrics that list ``workload`` among their cells."""
        for m in self.data["per_layer"]:
            if "workloads" not in m:
                raise Refused(f"per-layer metric {m['name']!r} lists no workloads")
        return [m for m in self.data["per_layer"] if workload in m["workloads"]]

    def reader(self, metric: str):
        path = self.root / "port_bench" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location("port_bench_metric_" + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Run:
    """One run of one workload: its inputs, the runner's state, the spans,
    the counters and, with ``--trace 1``, the trace's reduction."""

    def __init__(self, spec: Spec, workload: str, seed: int, seconds: float, trace: bool, device):
        from . import gen
        from .trace import Patches, Spans

        self.spec = spec
        self.cell = spec.workload(workload)
        self.workload = workload
        self.config = spec.config(self.cell["config"])
        self.traffic = spec.traffic(self.cell["traffic"])
        self.limits = spec.limits(workload)
        self.arch = gen.Arch.from_config(self.config)
        self.seed, self.seconds, self.trace, self.device = int(seed), float(seconds), bool(trace), device
        self.spans = Spans()
        self.patches = Patches()
        # what the runner's window writes: its counts, its end-to-end values, its length
        self.counts: Dict[str, float] = {}
        self.metrics: Dict[str, float] = {}
        self.window_s = 0.0
        self.setup_s = 0.0
        self.plain: Optional[Window] = None  # the measured window, without the profiler
        self.traced: Optional[Window] = None  # with --trace 1, the window under the profiler
        self.reduction = None  # and its trace.Reduction
        self.state = None  # the runner's
        self.check_s = 0.0  # time spent in set-up for the check alone (not set-up)

    def runner(self):
        return importlib.import_module(f"port_bench.runners.{self.traffic['runner']}")

    def window(self, seconds: float, check: bool) -> "Window":
        """One window of the runner's traffic; ``check``: keep what the
        check judges."""
        self.counts, self.metrics, self.window_s = {}, {}, 0.0
        self.spans.reset()
        self.runner().window(self, seconds, check)
        return Window(self)


class Window:
    """What one window left: its counts, end-to-end values and length, and
    the host seconds and call shapes of each span."""

    def __init__(self, run: Run):
        self.counts = dict(run.counts)
        self.metrics = dict(run.metrics)
        self.window_s = run.window_s
        self.host = {k: list(v) for k, v in run.spans.host.items()}
        self.calls = {k: list(v) for k, v in run.spans.calls.items()}


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell of the PyTorch/CUDA port.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / ".port_bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def device_info(torch, device, run: Run) -> dict:
    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": int(run.cell["chips"]),
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.reduction is not None:
        info["busy_s"] = run.reduction.busy_s
        info["window_s"] = run.reduction.window_s
    return info


def measure(run: Run, t_start: float) -> None:
    """Set up, then the measured window; with ``--trace 1`` then the
    traced one."""
    import torch

    from . import trace as tr

    run.runner().setup(run)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    run.setup_s = time.perf_counter() - t_start - run.check_s
    run.plain = run.window(run.seconds, check=True)
    if not run.trace:
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if run.device.type == "cuda" else [])
    run.spans.profiling = True
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(tr.PREFIX + "window"):
            run.traced = run.window(min(run.seconds, TRACED_S), check=False)
    run.spans.profiling = False
    run.reduction = tr.Reduction(tr.events_from_profiler(prof))


def execute(argv=None, root: Optional[Path] = None, require_chip: bool = True,
            t_start: Optional[float] = None) -> dict:
    """A whole run; returns its result line. ``require_chip=False``
    (the CPU tests) skips the look for a card and runs on the CPU."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = Path(root or ROOT)
    cache_dirs(root)
    import torch

    spec = Spec(root)
    cell = spec.workload(args.workload)
    if require_chip:
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false: this benchmark runs on a CUDA device")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{args.workload} needs {cell['chips']} devices, {torch.cuda.device_count()} visible")
        device = torch.device("cuda:0")
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    run = Run(spec, args.workload, args.seed, args.seconds, bool(args.trace), device)
    measure(run, t_start)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dev = device_info(torch, device, run)
    runner = run.runner()
    runner.release(run)
    check = importlib.import_module(f"port_bench.checks.{run.traffic['runner']}")
    compared = check.compare(run)
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in compared)
    if args.trace:
        metrics = {}
        for m in spec.per_layer(args.workload):
            v = spec.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(run.plain.metrics, setup_s=run.setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in spec.end_to_end(args.workload)}
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules of JAX or of the JAX package are loaded: {bad}")
    result = {
        "correct": bool(correct),
        "attempted": int(run.plain.counts.get("attempted", 0)),
        "failed": int(run.plain.counts.get("failed", 0)),
        "metrics": metrics,
        "device": dev,
    }
    if run.reduction is not None:
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in run.reduction.top_ops()],
                               "idle_gaps": run.reduction.top_gaps()}
    result["compared"] = {n: {"value": v, "limit": lim} for n, v, lim in compared}
    for n, v, lim in compared:
        print(f"compared {n} = {v!r} (limit {lim!r})", file=sys.stderr)
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    try:
        result = execute(argv, t_start=t_start)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result))
    return 0
