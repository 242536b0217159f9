"""Pipeline parallelism: GPipe microbatch pipelining over a mesh axis.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/parallel/pp.py``.
The layer stack is staged over a ``pipe`` mesh axis: stage *s* holds layers
``s * L/S .. (s + 1) * L/S - 1`` on the device at position *s* of the axis,
and microbatches stream through in the GPipe fill / steady / drain schedule
of ``M + S - 1`` ticks; at each tick an activation moves to the next
stage's device (the JAX ``ppermute``).

The row of the axis comes from ``parallel.mesh.axis_row``, so both layouts
of a mesh across processes run:

- the axis spans the processes: each rank holds a contiguous run of
  stages, builds only those stages' layers from ``stage_params`` and reads
  no other row of it; an activation whose next stage lies on another rank
  crosses by ``parallel.sharding.exchange``, and the last stage's outputs
  reach every rank (``sum_partials``, the JAX ``psum``);
- another axis spans the processes (or there is one process): each
  process runs its own row's pipeline over its own devices.

The schedule is one ``torch.autograd.Function``. Its forward runs the ticks
without autograd and keeps each stage's input for each microbatch; its
backward runs the ticks in reverse, recomputing each stage with autograd
and handing each microbatch's input gradient to the previous stage's
device or rank. That is the JAX package's transpose of its ``scan`` over
ticks, and it fixes the order of the hops on every rank (autograd's own
node order, left to itself, could pair two ranks' hops wrongly). CLIP itself
does not need it; it is exercised on the CLIP block stack
(``tests/test_torch_pp_sp_ep.py``, ``tests/test_torch_pp_sp_ep_multiprocess.py``,
``scripts/dryrun_multichip.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from .mesh import AxisRow, Mesh, Placement, axis_row
from .sharding import exchange, sum_gradients, sum_partials


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


class _Pipeline(torch.autograd.Function):
    """The ticks of this rank's stages: ``[M, mb, ...]`` outputs of the last
    stage where this rank holds it, zeros elsewhere (``pipeline_apply`` sums
    them over the ranks)."""

    @staticmethod
    def forward(ctx, layer_fn, row: AxisRow, names: List[str], xs, *tensors):
        n_stages, n_micro = row.size, xs.shape[0]
        mine = row.positions
        per_stage = tensors[0].shape[1]
        layers = {s: [{k: v[s, i].to(row.devices[s]) for k, v in zip(names, tensors)} for i in range(per_stage)]
                  for s in mine}

        def stage(s, h):
            for p in layers[s]:
                h = layer_fn(p, h)
            if h.shape != xs.shape[1:] or h.dtype != xs.dtype:
                raise ValueError(f"layer_fn turned a {tuple(xs.shape[1:])} {xs.dtype} microbatch into "
                                 f"{tuple(h.shape)} {h.dtype}: a pipelined layer keeps its input's shape and dtype")
            return h

        kept: Dict[tuple, torch.Tensor] = {}
        outs = torch.zeros_like(xs)
        arriving: Dict[int, torch.Tensor] = {}
        for t in range(n_micro + n_stages - 1):
            hop, sends, recvs = {}, {}, {}
            for s in mine:
                m = t - s
                if not 0 <= m < n_micro:
                    continue
                h = xs[m].to(row.devices[0]) if s == 0 else arriving[s]
                kept[s, m] = h
                y = stage(s, h)
                if s == n_stages - 1:
                    outs[m] = y.to(xs.device)
                elif row.owners[s + 1] == row.rank:
                    hop[s + 1] = y.to(row.devices[s + 1])
                else:  # the activation hop to the next stage's rank
                    sends[row.owners[s + 1]] = [y]
            first = mine[0]
            if first > 0 and 0 <= t - (first - 1) < n_micro:  # the previous rank's last stage sent this tick
                hop[first] = torch.empty(xs.shape[1:], dtype=xs.dtype, device=row.devices[first])
                recvs[row.owners[first - 1]] = [hop[first]]
            exchange(sends, recvs, row.group)
            arriving = hop
        ctx.layer_fn, ctx.row, ctx.names, ctx.kept, ctx.layers = layer_fn, row, names, kept, layers
        ctx.meta = (xs.shape, xs.dtype, xs.device, [(v.shape, v.dtype, v.device) for v in tensors])
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        row, kept = ctx.row, ctx.kept
        (xs_shape, xs_dtype, xs_device, metas) = ctx.meta
        n_stages, n_micro = row.size, xs_shape[0]
        mine = row.positions
        want_params = ctx.needs_input_grad[4:]
        g_params = [torch.zeros(shape, dtype=dt, device=d) if w else None
                    for (shape, dt, d), w in zip(metas, want_params)]
        g_xs = torch.zeros(xs_shape, dtype=xs_dtype, device=xs_device)
        leaves = {s: [{k: v.detach().requires_grad_(want_params[j]) for j, (k, v) in enumerate(p.items())}
                      for p in ctx.layers[s]] for s in mine}
        arriving: Dict[int, torch.Tensor] = {}
        for t in reversed(range(n_micro + n_stages - 1)):
            hop, sends, recvs = {}, {}, {}
            for s in reversed(mine):
                m = t - s
                if not 0 <= m < n_micro:
                    continue
                gy = g_outs[m].to(row.devices[s]) if s == n_stages - 1 else arriving[s]
                h = kept.pop((s, m)).detach().requires_grad_()
                with torch.enable_grad():
                    y = h
                    for p in leaves[s]:
                        y = ctx.layer_fn(p, y)
                    torch.autograd.backward(y, gy)
                if s == 0:
                    g_xs[m] = h.grad.to(xs_device)
                elif row.owners[s - 1] == row.rank:
                    hop[s - 1] = h.grad.to(row.devices[s - 1])
                else:  # the input gradient's hop back to the previous stage's rank
                    sends[row.owners[s - 1]] = [h.grad]
            last = mine[-1]
            if last < n_stages - 1 and 0 <= t - (last + 1) < n_micro:  # the next rank's first stage sent this tick
                hop[last] = torch.empty(xs_shape[1:], dtype=xs_dtype, device=row.devices[last])
                recvs[row.owners[last + 1]] = [hop[last]]
            exchange(sends, recvs, row.group)
            arriving = hop
        for s in mine:
            for i, p in enumerate(leaves[s]):
                for j, leaf in enumerate(p.values()):
                    if g_params[j] is not None and leaf.grad is not None:
                        g_params[j][s, i] = leaf.grad.to(g_params[j].device)
        return (None, None, None, g_xs, *g_params)


def pipeline_apply(
    layer_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor],
    stage_params: Dict[str, torch.Tensor],
    xs: torch.Tensor,
    mesh: Mesh,
    axis: str = "pipe",
) -> torch.Tensor:
    """Microbatches ``xs`` ``[M, mb, ...]`` through the staged stack; returns
    ``[M, mb, ...]`` on ``xs``' device, the same on every rank.
    ``layer_fn(params_one_layer, x)`` keeps ``x``'s shape and dtype (a
    residual block); ``stage_params`` has leading ``[S, L/S]`` axes
    (:func:`stack_stages`), one stage a position of ``axis``. Utilization
    ``M / (M + S - 1)``.

    Gradients reach ``stage_params`` and ``xs``. Across processes every
    rank computes the same loss from the (replicated) result and calls
    ``backward``: each rank's ``stage_params`` then holds the one-process
    gradient in its own stages' rows and zeros in the other rows (which it
    never reads, whatever they hold), and ``xs`` the one-process gradient on
    every rank. Each stage is computed twice: in the forward, and again in
    the backward, which recomputes it under autograd."""
    row = axis_row(mesh, axis)
    names = list(stage_params)
    tensors = [stage_params[k] for k in names]
    if tensors[0].shape[0] != row.size:
        raise ValueError(f"{tensors[0].shape[0]} stages do not split evenly over {axis}={row.size}: "
                         "one stage a position")
    outs = _Pipeline.apply(layer_fn, row, names, sum_gradients(xs, row.group), *tensors)
    return sum_partials(outs, row.group)
