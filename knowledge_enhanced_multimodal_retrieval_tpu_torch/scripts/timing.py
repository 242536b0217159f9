"""Timing and output helpers shared by the port's profiling scripts.

On a CUDA device a line is timed two ways, as ``chip_smoke.py`` and
``scripts/time_topk.py`` time the kernels: ``event_ms``, the median of
CUDA-event intervals around one call each (the wrapper's host time is in
it wherever the card waits for the host), and ``device_ms``, the same
median with a spin kernel queued first so the host enqueues ahead of the
card (the device's own time). On the CPU the scripts run their plain
versions to check the control flow, and the only time is ``host_ms``
(host clock): no device metric is taken there.

A script's JSON goes to ``--out``; the default is a file under the repo's
``chiprun_out/`` (git ignores it), never a tracked file.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from ..ops import dispatch

OUT_DIR = Path(__file__).resolve().parents[2] / "chiprun_out"


def default_out(name: str) -> str:
    """``chiprun_out/<name>`` at the root of the checkout."""
    return str(OUT_DIR / name)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn: Callable[[], object], device: torch.device, iters: int = 20, warmup: int = 3,
            spin_cycles: int = 1_000_000) -> Dict[str, float]:
    """Medians of ``iters`` calls of ``fn`` after ``warmup`` calls:
    ``{"event_ms", "device_ms"}`` on CUDA, ``{"host_ms"}`` on the CPU. The
    spin before each device-only call (``spin_cycles`` clock cycles, ~0.5 ms
    by default) must outlast the host's enqueue of one call."""
    for _ in range(warmup):
        fn()
    sync(device)
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return {"host_ms": statistics.median(times)}
    out = {}
    for key, spin in (("event_ms", False), ("device_ms", True)):
        times = []
        for _ in range(iters):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if spin:
                torch.cuda._sleep(spin_cycles)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[key] = statistics.median(times)
    return out


def ms_of(t: Dict[str, float]) -> float:
    """The line's headline time: event ms on the card, host ms on the CPU."""
    return t.get("event_ms", t.get("host_ms"))


def launches_of(fn: Callable[[], object], device: torch.device) -> Dict[str, int]:
    """The kernel launches of one call of ``fn`` (non-zero counts only; on
    the CPU nothing launches)."""
    sync(device)
    before = dispatch.launch_counts()
    fn()
    sync(device)
    after = dispatch.launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def card(device: torch.device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi reports them (None on the CPU)."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def write_json(payload: Dict, out: str) -> None:
    """Print ``payload`` as one JSON line and write it to ``out`` (empty: no file)."""
    print(json.dumps(payload), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {out}", flush=True)
