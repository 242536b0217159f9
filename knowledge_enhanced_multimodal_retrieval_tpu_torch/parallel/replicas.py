"""The module copies a step over a mesh's data shards computes on.

JAX runs one program per device; the port runs each data shard's towers on
that shard's device from one process. :class:`MeshReplicas` keeps one
module per distinct row of devices (a data shard's position along the
model axis): the caller's module where it already lives there with its own
parameters (data parallelism on a repeated device: ``[cuda:0] * 4``,
``[cpu] * 8``), otherwise a copy built on the ``meta`` device whose
parameters are bound, for the duration of a step's forward and backward,
to tensors made from the trained leaves on that row's device (``.to`` a
card), or built from a layout's blocks a unit at a time
(``parallel.fsdp.BlockGather``). The bound tensors stay in autograd, so a
backward pass leaves every gradient on the leaf that holds the optimizer
state, summed over the shards that used it.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Tuple

import torch
from torch import nn

from .mesh import MeshRuntime

Row = Tuple[torch.device, ...]


@contextlib.contextmanager
def bind_params(module: nn.Module, tensors: Mapping[str, torch.Tensor]) -> Iterator[None]:
    """``module``'s parameters named in ``tensors`` replaced by those tensors
    (graph tensors included) while the block runs."""
    saved = []
    try:
        for name, t in tensors.items():
            owner, _, leaf = name.rpartition(".")
            mod = module.get_submodule(owner) if owner else module
            saved.append((mod, leaf, mod._parameters[leaf]))
            mod._parameters[leaf] = t
        yield
    finally:
        for mod, leaf, p in reversed(saved):
            mod._parameters[leaf] = p


def meta_copy(model: nn.Module) -> nn.Module:
    """A parameterless copy of a CLIP (its structure on the ``meta`` device)."""
    remat = model.visual.transformer.remat
    with torch.device("meta"):
        return type(model)(model.arch, model.dtype, remat)


class MeshReplicas:
    """This process's data shards of ``rt`` (``(global index, device row)``
    in global order) and the module each computes on."""

    def __init__(self, model: nn.Module, rt: MeshRuntime, own_params: bool = True):
        self.model, self.rt = model, rt
        self.shards: List[Tuple[int, Row]] = rt.mesh.shard_rows_of_devices(rt.data_axes, rt.model_axis)
        home = next(model.parameters()).device
        self.modules: Dict[Row, nn.Module] = {}
        for _, row in self.shards:
            if row not in self.modules:
                mine = own_params and len(row) == 1 and row[0] == home
                self.modules[row] = model if mine else meta_copy(model)

    @property
    def home(self) -> torch.device:
        """Where per-shard results meet (the mesh's first device)."""
        return self.rt.mesh.first_device

    def module(self, row: Row) -> nn.Module:
        return self.modules[row]

    @contextlib.contextmanager
    def bound(self, tensors_for: Callable[[Row], Mapping[str, torch.Tensor]],
              hooks: Optional[Callable[[nn.Module, Row], contextlib.AbstractContextManager]] = None,
              rebind_own: bool = False) -> Iterator[None]:
        """Each copy bound to ``tensors_for(row)`` (the caller's own module
        keeps its parameters unless ``rebind_own``) and ``hooks(module,
        row)`` held, for the block's duration: hold it over a step's
        forward and backward."""
        with contextlib.ExitStack() as stack:
            for row, mod in self.modules.items():
                if rebind_own or mod is not self.model:
                    stack.enter_context(bind_params(mod, tensors_for(row)))
                if hooks is not None:
                    stack.enter_context(hooks(mod, row))
            yield

    def per_shard(self, fn: Callable[[nn.Module, int, Row, int], torch.Tensor]) -> torch.Tensor:
        """``fn(module, local index, row, global index)`` for each local
        shard, the results stacked on :attr:`home` (``[S, ...]``)."""
        return torch.stack([fn(self.modules[row], j, row, g).to(self.home)
                            for j, (g, row) in enumerate(self.shards)])


def moved(params: Mapping[str, torch.Tensor], device: torch.device) -> Dict[str, torch.Tensor]:
    """``params`` on ``device`` (in autograd; no copy where they already are)."""
    return {n: p.to(device) for n, p in params.items()}

