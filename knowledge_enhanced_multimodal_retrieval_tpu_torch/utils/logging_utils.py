"""Logging and metric persistence.

Functional parity with the reference's ``src/clip/utils/logging_utils.py``
(``setup_logger`` :12, ``log_metrics_to_jsonl`` :42, ``save_metrics_to_json``
:50) plus a rank-0 gate for multi-process runs (the reference's rank-0
pattern, ``trainer.py:117-131``). The port's own copy of the reference
package's ``utils/logging_utils.py``.
"""

from __future__ import annotations

import json
import logging
import os
import sys
from typing import Any, Mapping, Optional


def is_coordinator() -> bool:
    """True on the process that should write logs/checkpoints/metrics.

    The reference's ``rank == 0`` gating (``trainer.py:230-258,317-322``):
    in a ``torch.distributed`` run only rank 0 writes; a single process
    always does.
    """
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


def setup_logger(
    name: str = "kemr_torch",
    log_file: Optional[str] = None,
    level: int = logging.INFO,
    console: bool = True,
) -> logging.Logger:
    """Console + optional file logger (reference ``logging_utils.py:12-39``)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    if console:
        h = logging.StreamHandler(sys.stdout)
        h.setFormatter(fmt)
        logger.addHandler(h)
    if log_file:
        os.makedirs(os.path.dirname(os.path.abspath(log_file)), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def log_metrics_to_jsonl(metrics: Mapping[str, Any], jsonl_path: str) -> None:
    """Append one JSON line per call (reference ``logging_utils.py:42-47``).

    Only the coordinator process writes.
    """
    if not is_coordinator():
        return
    os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
    with open(jsonl_path, "a") as f:
        f.write(json.dumps(_jsonable(metrics)) + "\n")


def save_metrics_to_json(metrics: Mapping[str, Any], json_path: str) -> None:
    """Write final metrics as pretty JSON (reference ``logging_utils.py:50-55``)."""
    if not is_coordinator():
        return
    os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(_jsonable(metrics), f, indent=2)


def _jsonable(obj: Any) -> Any:
    """Best-effort conversion of tensor/numpy scalars and arrays to JSON types."""
    import numpy as np

    if isinstance(obj, Mapping):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.generic,)):
        return obj.item()
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):  # tensors / np arrays
        arr = np.asarray(obj)
        return arr.item() if arr.ndim == 0 else arr.tolist()
    return obj


class MetricsWriter:
    """Structured metrics sink: JSONL stream + final JSON, coordinator-gated.

    One object replaces the reference's scattered wandb/JSONL/JSON calls
    (``trainer.py:107,317-322``, ``logging_utils.py:42-55``).
    """

    def __init__(self, out_dir: str, run_name: str = "run"):
        self.out_dir = out_dir
        self.run_name = run_name
        self.jsonl_path = os.path.join(out_dir, f"{run_name}_metrics.jsonl")
        self.json_path = os.path.join(out_dir, f"{run_name}_final.json")

    def log(self, step: int, metrics: Mapping[str, Any]) -> None:
        log_metrics_to_jsonl({"step": step, **metrics}, self.jsonl_path)

    def finalize(self, metrics: Mapping[str, Any]) -> None:
        save_metrics_to_json(metrics, self.json_path)
