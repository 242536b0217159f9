"""Training checkpoints with the reference's latest/best semantics.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/train/checkpoint.py``.
The JAX package writes Orbax; the port writes its own format, readable
without JAX: ``torch.save`` of a nested dict of CPU tensors and plain
numbers (``params``, ``opt_state``, ``step``, optionally ``ema_params``),
read back with ``weights_only=True``. The contract is the JAX one:

- one file per role, ``checkpoint_{role}.pt`` under ``base_dir`` (roles
  ``latest`` and ``best``), beside a ``checkpoint_{role}.meta.json``
  sidecar of scalars;
- the device->host snapshot is synchronous (the caller goes on updating its
  tensors in place), the disk write asynchronous; a new save waits for the
  one before it, and :func:`wait_for_checkpoints` flushes every save;
- the data goes to a temporary name and is ``os.replace``d into place, and
  the sidecar is committed atomically *after* its data, latest-wins, so a
  crash mid-save never leaves metadata describing weights that were not
  written.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
from typing import Any, Dict, Tuple

import torch

from ..utils.logging_utils import is_coordinator


def _path(base: str, role: str) -> str:
    return os.path.join(os.path.abspath(base), f"checkpoint_{role}.pt")


def to_host(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor detached on the CPU (nested
    dicts, lists and plain values kept as they are)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


_SEQ = itertools.count()
_LOCK = threading.Lock()
_META_LATEST: Dict[str, int] = {}
_WRITERS: list = []
_ERRORS: list = []


def wait_for_checkpoints() -> None:
    """Block until every pending save (data and sidecar) has committed;
    re-raise the first error a writer met."""
    while True:
        with _LOCK:
            pending = [t for t in _WRITERS if t.is_alive()]
            _WRITERS[:] = pending
        if not pending:
            break
        for t in pending:
            t.join()
    with _LOCK:
        errors, _ERRORS[:] = list(_ERRORS), []
    if errors:
        raise errors[0]


def _write_meta(path: str, meta_text: str, seq: int) -> None:
    """Atomically commit the sidecar (latest-wins across saves of a path)."""
    with _LOCK:
        if _META_LATEST.get(path, -1) > seq:
            return  # a newer save's sidecar already committed
        _META_LATEST[path] = seq
        tmp = f"{path}.meta.json.tmp-{seq}"
        with open(tmp, "w") as f:
            f.write(meta_text)
        os.replace(tmp, meta_path(path))


def meta_path(path: str) -> str:
    return path[: -len(".pt")] + ".meta.json"


def _write(path: str, host_state: Any, meta_text: str, seq: int) -> None:
    try:
        tmp = f"{path}.tmp-{seq}"
        torch.save(host_state, tmp)
        os.replace(tmp, path)
        _write_meta(path, meta_text, seq)
    except Exception as e:  # noqa: BLE001 -- the writer thread's boundary: wait_for_checkpoints re-raises it
        with _LOCK:
            _ERRORS.append(e)


def save_checkpoint(base_dir: str, role: str, state: Any, metadata: Dict[str, Any], wait: bool = False) -> None:
    """Snapshot ``state`` to the host now, write it (and then its sidecar)
    in the background; ``wait=True`` flushes before returning. Only the
    coordinator writes."""
    if not is_coordinator():
        return
    wait_for_checkpoints()  # one save at a time: the previous one lands first
    path = _path(base_dir, role)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    host_state = to_host(state)
    seq = next(_SEQ)
    meta_text = json.dumps(metadata, indent=2)
    t = threading.Thread(target=_write, args=(path, host_state, meta_text, seq), daemon=True, name="kemr-ckpt")
    with _LOCK:
        _WRITERS.append(t)
    t.start()
    if wait:
        wait_for_checkpoints()


def load_checkpoint(base_dir: str, role: str) -> Tuple[Any, Dict[str, Any]]:
    """The saved state (CPU tensors) and its sidecar's metadata."""
    path = _path(base_dir, role)
    wait_for_checkpoints()  # an in-flight save of this path lands first
    state = torch.load(path, map_location="cpu", weights_only=True)
    meta = meta_path(path)
    metadata = {}
    if os.path.exists(meta):
        with open(meta) as f:
            metadata = json.load(f)
    return state, metadata


def checkpoint_exists(base_dir: str, role: str) -> bool:
    return os.path.exists(_path(base_dir, role))


def load_params_only(base_dir: str, role: str) -> Dict[str, torch.Tensor]:
    """The serving weights of a training checkpoint, by the CLIP module's
    parameter names (CPU f32 tensors): ``ema_params`` when the run kept an
    EMA shadow (what validation and the best-checkpoint monitor scored),
    else ``params``."""
    state, _ = load_checkpoint(base_dir, role)
    if "params" not in state:
        raise ValueError(f"{_path(base_dir, role)} is not a training checkpoint (no 'params')")
    return state["ema_params"] if "ema_params" in state else state["params"]
