"""Pipeline parallelism: GPipe microbatch pipelining over a mesh axis.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/parallel/pp.py``.
The layer stack is staged over a ``pipe`` mesh axis: stage *s* holds layers
``s * L/S .. (s + 1) * L/S - 1`` on the device at position *s* of the axis,
and microbatches stream through in the GPipe fill / steady / drain schedule
of ``M + S - 1`` ticks; at each tick an activation moves to the next
stage's device with ``.to`` (the JAX ``ppermute``). The schedule is plain
autograd, so the backward pass is the reverse pipeline. The axis must lie
inside one process (:func:`local_axis_devices`). CLIP itself does not need
it; it is exercised on the CLIP block stack (``tests/test_torch_pp_sp_ep.py``,
``scripts/dryrun_multichip.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from .mesh import Mesh, Placement


def local_axis_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    """The devices along ``axis`` (the other coordinates 0): pipeline,
    sequence and expert parallelism run over an axis inside one process."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}: {dict(mesh.shape)}")
    if mesh.process_count > 1 and mesh.axis_names[0] == axis:
        raise ValueError(f"the {axis!r} axis spans {mesh.process_count} processes: pipeline, sequence and "
                         "expert parallelism run over an axis inside one process")
    return [dev for _, dev in mesh.axis_shards(axis)]


def stack_stages(per_layer_params: Sequence[Dict[str, torch.Tensor]], num_stages: int) -> Dict[str, torch.Tensor]:
    """Per-layer parameter dicts -> one dict whose tensors gain leading
    ``[S, L/S]`` axes (contiguous stages)."""
    n = len(per_layer_params)
    if n % num_stages:
        raise ValueError(f"{n} layers do not split into {num_stages} equal stages")
    return {k: torch.stack([p[k] for p in per_layer_params]).reshape(
        (num_stages, n // num_stages) + tuple(per_layer_params[0][k].shape)) for k in per_layer_params[0]}


def stage_sharding(mesh: Mesh, stage_params: Dict[str, torch.Tensor], axis: str = "pipe") -> Dict[str, Placement]:
    """Each stage's slice (dim 0) on its pipeline device."""
    return {k: Placement(mesh, (axis,) + (None,) * (v.ndim - 1)) for k, v in stage_params.items()}


def pipeline_apply(
    layer_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor],
    stage_params: Dict[str, torch.Tensor],
    xs: torch.Tensor,
    mesh: Mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Microbatches ``xs`` ``[M, mb, ...]`` through the staged stack; returns
    ``[M, mb, ...]`` on ``xs``' device. ``layer_fn(params_one_layer, x)``
    keeps ``x``'s shape (a residual block); ``stage_params`` has leading
    ``[S, L/S]`` axes (:func:`stack_stages`). Utilization ``M / (M + S - 1)``."""
    devs = local_axis_devices(mesh, axis)
    n_stages, n_micro = len(devs), xs.shape[0]
    per_stage = next(iter(stage_params.values())).shape[1]
    # each stage's layers on its device (in autograd: the gradient returns to the stacked tensors)
    layers = [[{k: v[s, i].to(devs[s]) for k, v in stage_params.items()} for i in range(per_stage)]
              for s in range(n_stages)]

    def stage(s: int, h: torch.Tensor) -> torch.Tensor:
        for p in layers[s]:
            h = layer_fn(p, h)
        return h

    outs: List[torch.Tensor] = [None] * n_micro  # type: ignore[list-item]
    arriving: Dict[int, torch.Tensor] = {}
    for t in range(n_micro + n_stages - 1):
        hop = {}
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:
                continue
            h = xs[m].to(devs[0]) if s == 0 else arriving[s]
            y = stage(s, h)
            if s == n_stages - 1:
                outs[m] = y.to(xs.device)
            else:
                hop[s + 1] = y.to(devs[s + 1])  # the activation hop to the next stage
        arriving = hop
    return torch.stack(outs)
