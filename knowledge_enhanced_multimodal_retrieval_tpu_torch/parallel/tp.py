"""Tensor-parallel parameter sharding for the CLIP towers (Megatron column / row).

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/parallel/tp.py``.
The block projections are cut over the ``model`` mesh axis, which never
spans processes (``parallel.mesh.make_mesh`` splits only the leading axis);
in the port's ``[out, in]`` layout (the JAX kernels are ``[in, out]``):

- ``attn.in_proj_weight`` ``[3w, w]`` and ``mlp.c_fc.weight`` ``[4w, w]``
  are column-parallel: cut on dim 0 (JAX ``P(None, model)``), their biases
  with them; each device computes its slice of the outputs and the slices
  are concatenated (the fused qkv output splits as ``[q|k|v]``: the slices
  are joined before the head reshape, so a cut across the q / k boundary
  is fine);
- ``attn.out_proj.weight`` ``[w, w]`` and ``mlp.c_proj.weight`` ``[w, 4w]``
  are row-parallel: cut on dim 1 (JAX ``P(model, None)``); each device
  multiplies its slice of the input features, the partial sums are added
  and the bias once;
- everything else is whole on every device.

:func:`tp_projections` installs :func:`tp_linear` at ``models.clip``'s
``block_linear`` seam for a forward (and its backward).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Mapping, Sequence

import torch
from torch import nn

from ..models.clip import projection_hooks
from .mesh import Mesh, Placement
from .sharding import ShardedParams, Spec

_COLUMN = ("attn.in_proj_weight", "attn.in_proj_bias", "mlp.c_fc.weight", "mlp.c_fc.bias")
_ROW = ("attn.out_proj.weight", "mlp.c_proj.weight")


def tp_param_pspecs(params: Mapping[str, torch.Tensor], model_axis: str = "model") -> Dict[str, Spec]:
    """Per parameter (port names, any subset of a CLIP's) its spec under
    the Megatron column / row rules; names no rule matches stay whole."""

    def spec(name: str, leaf: torch.Tensor) -> Spec:
        if name.endswith(_COLUMN):
            return (model_axis,) + (None,) * (leaf.ndim - 1)
        if name.endswith(_ROW):
            return (None, model_axis)
        return (None,) * leaf.ndim

    return {n: spec(n, p) for n, p in params.items()}


def tp_shardings(params: Mapping[str, torch.Tensor], mesh: Mesh, model_axis: str = "model") -> Dict[str, Placement]:
    """A :class:`~.mesh.Placement` per parameter (whole over the data axis, as in the DP step)."""
    return {n: Placement(mesh, s) for n, s in tp_param_pspecs(params, model_axis).items()}


def shard_params_tp(params: Mapping[str, torch.Tensor], mesh: Mesh, model_axis: str = "model") -> ShardedParams:
    """``params`` cut over the model axis as trainable blocks."""
    return ShardedParams(dict(params), mesh, tp_param_pspecs(params, model_axis))


def tp_linear(name: str, x: torch.Tensor, w: Sequence[torch.Tensor], b, devices: Sequence[torch.device]) -> torch.Tensor:
    """One block projection over the model axis: ``w`` the weight's blocks
    (block *m* on ``devices[m]``), ``b`` the bias's blocks (column) or the
    whole bias (row); the result on ``x``'s device in ``x``'s dtype."""
    dt, home = x.dtype, x.device
    if name in ("in_proj_weight", "c_fc.weight"):
        return torch.cat([nn.functional.linear(x.to(d), wm.to(dt), bm.to(dt)).to(home)
                          for wm, bm, d in zip(w, b, devices)], dim=-1)
    k = w[0].shape[1]
    out = None
    for m, (wm, d) in enumerate(zip(w, devices)):
        part = nn.functional.linear(x[..., m * k:(m + 1) * k].to(d), wm.to(dt)).to(home)
        out = part if out is None else out + part
    return out + b.to(dt)


def tp_projections(model: nn.Module, weights: Callable[[str], tuple],
                   devices: Sequence[torch.device]) -> contextlib.AbstractContextManager:
    """Every block projection of ``model`` through :func:`tp_linear` while
    the block runs: ``weights(prefix + "." + name)`` gives a projection's
    ``(weight blocks, bias or bias blocks)``. With a projection hook also
    set (QAT), the weight's blocks are joined and the hook sees the whole
    weight, as the JAX package's fake quantization does."""

    def make(prefix: str):
        def linear(name: str, x: torch.Tensor, hook) -> torch.Tensor:
            w, b = weights(f"{prefix}.{name}")
            if hook is None:
                return tp_linear(name, x, w, b, devices)
            col = name in ("in_proj_weight", "c_fc.weight")
            whole = torch.cat([t.to(x.device) for t in w], dim=0 if col else 1)
            bias = torch.cat([t.to(x.device) for t in b]) if col else b.to(x.device)
            x, whole = hook(name, x, whole)
            return nn.functional.linear(x, whole.to(x.dtype), bias.to(x.dtype))

        return linear

    return projection_hooks(model, make, attr="parallel_linear")
