"""Sharding helpers: row shards, replicas, padding, the cross-process gather.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/parallel/sharding.py``
for serving. ``batch_sharding`` / ``replicated`` become placements that put
a tensor on a :class:`~.mesh.Mesh` as a :class:`RowShards` (rows cut into
equal contiguous shards, shard *i* on the device at position *i* of the
axis) or as one copy per distinct device. A shard on the device that
already holds the rows is a view, not a copy. ``host_local_batch_to_global``
and ``shard_params`` belong to the sharded training steps (ROADMAP A5 (b)).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh, Placement

_TMA_ALIGN = 16  # bytes: the kernels' tensor maps need 16-byte-aligned global addresses


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> Placement:
    """Shard dim 0 over ``axis``, replicate the rest."""
    return Placement(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, pad_value=0) -> tuple:
    """Pad ``x`` along ``axis`` to a multiple of ``multiple``; returns
    ``(padded, original_len)`` (a sharded dim must divide the axis size)."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return np.pad(x, widths, constant_values=pad_value), n


def unreplicate(x: Any) -> Any:
    """Fetch a tensor (or a dict / list / tuple of them) to host numpy."""
    if torch.is_tensor(x):
        t = x.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    if isinstance(x, RowShards):
        return unreplicate(x.gather())
    if isinstance(x, dict):
        return {k: unreplicate(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(unreplicate(v) for v in x)
    return np.asarray(x)


@dataclasses.dataclass(eq=False)
class RowShards:
    """An array row-sharded over one mesh axis: this process's shards as
    ``(global shard index, tensor on its device)`` pairs, each ``shard_n``
    rows of the ``n_shards * shard_n`` global ones."""

    shards: List[Tuple[int, torch.Tensor]]
    shard_n: int
    n_shards: int
    mesh: Mesh
    axis: str

    @property
    def shape(self) -> tuple:
        return (self.shard_n * self.n_shards,) + tuple(self.shards[0][1].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0][1].dtype

    def gather(self) -> torch.Tensor:
        """This process's shards concatenated on the mesh's first device
        (every shard when one process holds the mesh)."""
        dev = self.mesh.first_device
        return torch.cat([t.to(dev) for _, t in self.shards])


def shard_rows(x, mesh: Mesh, axis: str = "data") -> RowShards:
    """Cut the global rows of ``x`` (a tensor or host array) into
    ``mesh.shape[axis]`` equal shards and place this process's on their
    devices: a row view where ``x`` already lives on that device, a copy
    otherwise. A CUDA view must start on a 16-byte boundary (the kernels
    read their rows through tensor maps); this is asserted here, where the
    shard is cut."""
    if isinstance(x, RowShards):
        return x
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    n_shards = mesh.shape[axis]
    if t.shape[0] % n_shards:
        raise ValueError(f"{t.shape[0]} rows do not shard {n_shards} ways (pad to a multiple first)")
    shard_n = t.shape[0] // n_shards
    targets = {dev for _, dev in mesh.axis_shards(axis)}
    if mesh.process_count == 1 and len(targets) == 1:
        t = t.to(next(iter(targets)))  # one staged copy, every shard a view of it
    t = t.contiguous()
    row_bytes = t[0].numel() * t.element_size() if t.shape[0] else 0
    out = []
    for g, dev in mesh.axis_shards(axis):
        part = t[g * shard_n:(g + 1) * shard_n]
        if part.device == dev:
            if dev.type == "cuda" and row_bytes >= _TMA_ALIGN:
                assert part.data_ptr() % _TMA_ALIGN == 0, (
                    f"shard {g} of {tuple(t.shape)} starts at {part.data_ptr():#x}, not 16-byte aligned")
        else:
            part = part.to(dev)
        out.append((g, part))
    return RowShards(out, shard_n, n_shards, mesh, axis)


def replicate(x, mesh: Mesh) -> Dict[torch.device, torch.Tensor]:
    """One copy of ``x`` per distinct device of the mesh (the tensor itself
    on the device it already lives on)."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    out: Dict[torch.device, torch.Tensor] = {}
    for dev in mesh.local_devices:
        if dev not in out:
            out[dev] = t if t.device == dev else t.to(dev)
    return out


def all_gather_processes(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[P * x.shape[0], ...]``: every process's ``x`` concatenated in
    process order, on ``x``'s device; ``x`` itself on a mesh of one process
    without ``torch.distributed``. Under gloo the tensors cross as CPU
    tensors (gloo gathers no CUDA tensor); under NCCL on the rank's card."""
    if mesh.group is None:
        return x
    import torch.distributed as dist

    nccl = dist.get_backend(mesh.group) == "nccl"
    src = (x.to(torch.device("cuda", torch.cuda.current_device())) if nccl else x.cpu()).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(x.device)


def gather_shard_outputs(outs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Per-shard outputs of this process (each ``[Q, ...]``, any device) ->
    ``[n_shards_global, Q, ...]`` on the mesh's first device, shard-major
    across processes."""
    dev = mesh.first_device
    local = torch.stack([o.to(dev) for o in outs])
    return all_gather_processes(local, mesh)
