"""Profiling hooks.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/utils/profiling.py``:
:func:`trace` captures a ``torch.profiler`` trace (CPU and CUDA activity)
into ``log_dir`` as a Chrome trace, :func:`annotate` names a region in it
(``torch.profiler.record_function``), and :class:`StepTimer` is the same
rolling step timer.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a trace: ``with trace('profile_dir'): step()`` writes
    ``profile_dir/trace.json`` (load it in Perfetto or ``chrome://tracing``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Name a region in the trace timeline."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Rolling step timing (steps/sec, examples/sec) for training loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def stats(self, batch_size: int = 1) -> Dict[str, float]:
        if not self._times:
            return {}
        mean = sum(self._times) / len(self._times)
        return {
            "step_time_s": mean,
            "steps_per_sec": 1.0 / mean,
            "examples_per_sec": batch_size / mean,
        }
