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
- :class:`BlockGather` builds the parameters near their use, as XLA's
  GSPMD gathers them before each layer in the JAX package: a residual
  block's when its forward starts (one flat all-gather across processes),
  released when it ends; each leaf outside the blocks where it is read.
  Nothing built, and no cast of it, is kept for the backward, which builds
  each block again and recomputes it (the forward keeps the block's input
  only). Autograd leaves each block the sum of its gradients over every use
  (the reduce-scatter), so each position updates only its own block. Blocks
  on other processes cross through ``torch.distributed``
  (``parallel.sharding.all_gather_autograd``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from ..models.clip import ResidualBlock
from ..models.convert import flax_dims
from .mesh import Mesh, Placement
from .replicas import Row, bind_params
from .sharding import ShardedParams, Spec
from .tp import tp_projections


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


Item = Tuple[str, Optional[int], torch.device]  # (parameter, its block along the kept axis or None, device)


class _BuiltOnRead(dict):
    """A module's ``_parameters`` whose every read builds the parameter anew
    (``nn.Module.__getattr__`` reads it by key): each use holds its own
    copy, released with the expression that used it."""

    def __init__(self, params, build: Callable[[str], torch.Tensor]):
        super().__init__(params)
        self.build = build

    def __getitem__(self, key):
        return self.build(key)


class _BlockRecompute(torch.autograd.Function):
    """One residual block from built parameters: the forward keeps no graph
    (its input only), the backward builds the block's parameters again,
    recomputes the block and differentiates it to its input and to its
    parameters' blocks (``leaves``)."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        ctx.run, ctx.leaves = run, leaves
        ctx.save_for_backward(x)
        with torch.no_grad():
            return run(x)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        x = x.detach().requires_grad_(ctx.needs_input_grad[1])
        with torch.enable_grad():
            y = ctx.run(x)
        inputs = ([x] if x.requires_grad else []) + list(ctx.leaves)
        grads = list(torch.autograd.grad(y, inputs, gy, allow_unused=True))
        gx = grads.pop(0) if x.requires_grad else None
        return (None, gx, *grads)


class BlockGather:
    """FSDP's build of a layout's parameters for the modules of a mesh's
    device rows (``parallel.replicas``: parameterless copies), one unit at a
    time (ZeRO-3):

    - a residual block runs as one :class:`_BlockRecompute`: its parameters
      are built on the row when its forward starts and released when it
      ends, and built again in the backward, which recomputes the block
      (so the forward keeps only the block's input; ``--model.remat`` adds
      nothing); those cut over ``keep`` (the tensor-parallel projections)
      stay apart, block *m* on the row's device *m*, for ``parallel.tp``'s
      projections;
    - each leaf outside the blocks (embeddings, patch conv, positions, the
      LayerNorms around the blocks, the projections) is built where it is
      read; under :meth:`saving` a tensor autograd saves that is such a
      build, a cast or move of one, or a cast or move of a block itself is
      saved as a handle, and the backward builds it again.

    Every process issues the same builds in the same order: the forward's
    and the backward's follow the graph."""

    def __init__(self, layout: ShardedParams, keep: Optional[str] = None):
        self.layout, self.keep = layout, keep
        self.kept = {n for n, spec in layout.specs.items() if keep is not None and keep in spec}
        self.block_ids = {id(b) for blocks in layout.blocks.values() for b in blocks.values()}
        self.unit_names: Dict[str, List[str]] = {}  # a block's prefix -> its parameters
        self.nodes: Dict[Any, tuple] = {}  # grad_fn of a leaf built in a forward -> (row, leaf, item)
        self.cache: Dict[Tuple[Row, torch.device], tuple] = {}  # the backward's leaf builds: (leaf, {item: tensor})
        self.current: Dict[Row, Dict[str, Any]] = {}  # the block being run on each row, by parameter

    def _items(self, unit: str, row: Row) -> List[Item]:
        names = self.unit_names.get(unit, [unit])
        return [it for n in names for it in (
            [(n, m, row[m]) for m in range(len(row))] if n in self.kept else [(n, None, row[0])])]

    def _build(self, row: Row, items: List[Item]) -> Dict[Item, torch.Tensor]:
        out = {}
        for dev in dict.fromkeys(it[2] for it in items):
            self.cache.pop((row, dev), None)  # what the backward built there is released first
            mine = [it for it in items if it[2] == dev]
            out.update(zip(mine, self.layout.gather([(n, m) for n, m, _ in mine], dev, self.keep)))
        return out

    @contextlib.contextmanager
    def _block(self, row: Row, prefix: str, block: nn.Module):
        cur: Dict[str, Any] = {}
        for (n, m, _), t in self._build(row, self._items(prefix, row)).items():
            if m is None:
                cur[n] = t
            else:
                cur.setdefault(n, [None] * len(row))[m] = t
        self.current[row] = cur
        try:
            with bind_params(block, {n[len(prefix) + 1:]: t for n, t in cur.items() if n not in self.kept}):
                yield
        finally:
            self.current.pop(row, None)
            cur = None

    def _run(self, row: Row, prefix: str, block: nn.Module, x: torch.Tensor, causal: bool) -> torch.Tensor:
        """``ResidualBlock.runner``: the block from its built parameters."""

        def run(x):
            with self._block(row, prefix, block):
                return block.body(x, causal)

        if not torch.is_grad_enabled():
            return run(x)
        leaves = [b for n in self.unit_names[prefix] for b in self.layout.blocks[n].values()]
        return _BlockRecompute.apply(run, x, *leaves)

    def _leaf(self, row: Row, prefix: str, leaf: str) -> torch.Tensor:
        items = self._items(prefix + leaf, row)
        t = self._build(row, items)[items[0]]
        if t.grad_fn is not None:
            self.nodes[t.grad_fn] = (row, prefix + leaf, items[0])
        return t

    def _weights(self, row: Row, name: str):
        """A tensor-parallel projection's (weight blocks, bias or its blocks) in the block's forward."""
        cur = self.current[row]
        return cur[name], cur[name[:-len("weight")] + "bias"]  # in_proj_weight -> in_proj_bias

    def _rebuild(self, row: Row, leaf: str, item: Item) -> torch.Tensor:
        key = (row, item[2])
        if self.cache.get(key, (None,))[0] != leaf:  # _build releases the leaf cached there first
            self.cache[key] = (leaf, self._build(row, [item]))
        return self.cache[key][1][item]

    def _pack(self, t: torch.Tensor):
        base = t if t._base is None else t._base
        fn = base.grad_fn
        if fn is None:
            return t
        rec = self.nodes.get(fn)
        if rec is None:
            if type(fn).__name__ != "ToCopyBackward0":
                return t
            src = fn.next_functions[0][0]
            rec = self.nodes.get(src)
            if rec is None:
                rec = getattr(src, "variable", None)  # AccumulateGrad: a cast of a block itself
                if rec is None or id(rec) not in self.block_ids:
                    return t
        return rec, base.dtype, base.device, t.shape, t.stride(), t.storage_offset()

    def _unpack(self, packed):
        if isinstance(packed, torch.Tensor):
            return packed
        rec, dtype, device, shape, stride, offset = packed
        with torch.no_grad():
            base = rec.detach() if isinstance(rec, torch.Tensor) else self._rebuild(*rec)
            base = base.to(device, dtype)
        return base.as_strided(shape, stride, offset)

    def saving(self) -> contextlib.AbstractContextManager:
        """Hold it over a forward (not the backward, which builds again
        anyway): what autograd saves of the leaves built outside the blocks
        becomes a handle (:meth:`_pack`)."""
        return torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)

    @contextlib.contextmanager
    def bound(self, modules: Mapping[Row, nn.Module],
              hooks: Optional[Callable[[nn.Module, Row], contextlib.AbstractContextManager]] = None):
        """Each row's module computing from the layout's blocks, built a unit
        at a time, and ``hooks(module, row)`` (QAT) held, while the context
        is: hold it over a step's forward and backward."""
        with contextlib.ExitStack() as stack:
            for row, mod in modules.items():
                blocks = [(n, b) for n, b in mod.named_modules() if isinstance(b, ResidualBlock)]
                for prefix, block in blocks:
                    self.unit_names.setdefault(prefix, [n for n in self.layout.specs if n.startswith(prefix + ".")])
                    block.runner = functools.partial(self._run, row, prefix)
                    stack.callback(delattr, block, "runner")
                for name, m in mod.named_modules():
                    if m._parameters and not any(name.startswith(p + ".") for p, _ in blocks):
                        own = m._parameters
                        build = functools.partial(self._leaf, row, name + "." if name else "")
                        m.__dict__["_parameters"] = _BuiltOnRead(own, build)
                        stack.callback(m.__dict__.__setitem__, "_parameters", own)
                if hooks is not None:
                    stack.enter_context(hooks(mod, row))
                if self.kept:
                    stack.enter_context(tp_projections(mod, functools.partial(self._weights, row), row))
            try:
                yield
            finally:
                self.nodes.clear()
                self.cache.clear()
                self.current.clear()
