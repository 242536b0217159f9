"""FSDP / ZeRO-3 parameter sharding over the data axis.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/parallel/fsdp.py``.
Parameters and both AdamW moments are cut over the ``data`` mesh axis, so
each position's train state is 1/n of the replicated one:

- :func:`fsdp_param_pspecs` cuts each parameter along its largest
  n-divisible dimension; leaves below ``min_size`` elements (LayerNorms,
  biases, scalars) stay whole, as in the JAX package. The dimension is
  chosen in the JAX package's flax layout (``models.convert.flax_dims``):
  the port's weights are ``[out, in]`` where flax kernels are ``[in, out]``,
  and a square weight's tie goes to flax's first dimension, so both
  packages cut the same logical dimension (``tests/test_torch_fsdp_tp.py``
  compares the specs leaf by leaf);
- ``base`` composes with tensor parallelism (``parallel.tp``): a leaf
  already cut over the model axis is cut over the data axis on another
  divisible dimension;
- the train step (``train.trainer.make_train_step_gspmd``) assembles each
  parameter from its blocks before use and autograd leaves each block the
  sum of its gradients (the reduce-scatter), so each position updates only
  its own block. Blocks on other processes cross through
  ``torch.distributed`` (``parallel.sharding.all_gather_autograd``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from ..models.convert import flax_dims
from .mesh import Mesh, Placement
from .sharding import ShardedParams, Spec


def fsdp_param_pspecs(
    params: Mapping[str, torch.Tensor],
    n_shards: int,
    data_axis: str = "data",
    min_size: int = 1024,
    base: Optional[Mapping[str, Spec]] = None,
) -> Dict[str, Spec]:
    """Per parameter (port names and ``[out, in]`` layout) a spec cutting
    its largest ``n_shards``-divisible dimension over ``data_axis``, the
    JAX package's rule applied in flax's dimension order; ``base`` (e.g.
    :func:`parallel.tp.tp_param_pspecs`) keeps its cuts and adds the data
    axis on another dimension where one divides."""

    def spec(name: str, leaf: torch.Tensor) -> Spec:
        existing = tuple(base[name]) if base is not None and name in base else ()
        existing = existing + (None,) * (leaf.ndim - len(existing))
        taken = {i for i, a in enumerate(existing) if a is not None}
        if leaf.ndim == 0 or leaf.numel() < min_size:
            return existing if taken else (None,) * leaf.ndim
        perm = flax_dims(name, leaf.ndim)  # port dim i is flax dim perm[i]
        flax_shape = [0] * leaf.ndim
        for i, f in enumerate(perm):
            flax_shape[f] = leaf.shape[i]
        for f in sorted(range(leaf.ndim), key=lambda f: flax_shape[f], reverse=True):
            d = perm.index(f)
            if d not in taken and leaf.shape[d] % n_shards == 0:
                out = list(existing)
                out[d] = data_axis
                return tuple(out)
        return existing

    return {n: spec(n, p) for n, p in params.items()}


def fsdp_shardings(
    params: Mapping[str, torch.Tensor],
    mesh: Mesh,
    data_axis: str = "data",
    min_size: int = 1024,
    base: Optional[Mapping[str, Spec]] = None,
) -> Dict[str, Placement]:
    """A :class:`~.mesh.Placement` per parameter for :func:`fsdp_param_pspecs` over ``mesh``."""
    if data_axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {data_axis!r}: {dict(mesh.shape)}")
    specs = fsdp_param_pspecs(params, mesh.shape[data_axis], data_axis, min_size, base)
    return {n: Placement(mesh, s) for n, s in specs.items()}


def shard_params_fsdp(params: Mapping[str, torch.Tensor], mesh: Mesh, data_axis: str = "data",
                      min_size: int = 1024, base: Optional[Mapping[str, Spec]] = None) -> ShardedParams:
    """``params`` cut over the data axis as trainable blocks."""
    specs = {n: pl.spec for n, pl in fsdp_shardings(params, mesh, data_axis, min_size, base).items()}
    return ShardedParams(dict(params), mesh, specs)
