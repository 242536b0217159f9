"""Expert parallelism: a mixture-of-experts MLP over a mesh axis.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/parallel/ep.py``:
a GShard / Switch top-k routed expert FFN with capacity-factor dense
dispatch. Routing gives fixed-shape one-hot ``dispatch`` / ``combine``
tensors ``[T, E, C]``; the layer is three einsums (dispatch, the expert
FFN, combine). Slots are first come, first served per expert in GShard
order (every token's first choice before any second choice); a token past
an expert's capacity gets zero weight there, so dropped tokens pass through
the residual only. The Switch load-balancing loss comes back beside the
output. ``jax.nn.gelu`` is the tanh approximation, so the experts use
``F.gelu(approximate="tanh")``. Over a mesh (:func:`ep_shardings`) each
position of the ``expert`` axis holds and computes its experts' share of
the three einsums, and the partial outputs are summed. The row of the axis
comes from ``parallel.mesh.axis_row``: where the axis spans the processes,
each rank computes only its own positions' experts, the shares read
``xt``, ``dispatch`` and ``combine`` through ``sum_gradients`` and are summed
over the ranks by ``sum_partials`` (``parallel.sharding``); the router,
routing and ``aux`` are computed alike on every rank. Where another axis
spans the processes, each process runs its own row.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .mesh import Mesh, Placement, axis_row
from .sharding import sum_gradients, sum_partials

MoEParams = Dict[str, Any]


def init_moe_params(generator: torch.Generator, width: int, hidden: int, num_experts: int,
                    dtype: torch.dtype = torch.float32) -> MoEParams:
    """Router + expert-stacked FFN: ``router.kernel [W, E]`` (f32), ``w_in
    [E, W, H]``, ``b_in [E, H]``, ``w_out [E, H, W]``, ``b_out [E, W]`` (no
    transpose: the JAX layout), drawn on the CPU from ``generator``."""
    s_in, s_out = 1.0 / math.sqrt(width), 1.0 / math.sqrt(hidden)
    randn = lambda *shape: torch.randn(*shape, generator=generator)  # noqa: E731
    return {
        "router": {"kernel": randn(width, num_experts) * s_in},
        "w_in": (randn(num_experts, width, hidden) * s_in).to(dtype),
        "b_in": torch.zeros(num_experts, hidden, dtype=dtype),
        "w_out": (randn(num_experts, hidden, width) * s_out).to(dtype),
        "b_out": torch.zeros(num_experts, width, dtype=dtype),
    }


def _capacity(tokens: int, num_experts: int, k: int, capacity_factor: float) -> int:
    return max(1, int(math.ceil(tokens * k * capacity_factor / num_experts)))


def router_dispatch(logits: torch.Tensor, k: int, capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing -> ``(dispatch, combine, aux_loss)``: ``dispatch``
    ``[T, E, C]`` one-hot, ``combine`` the same support scaled by the
    renormalized top-k gate, ``aux_loss`` the Switch load-balancing scalar."""
    t, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = probs.topk(k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    choice = F.one_hot(gate_idx, e).float()  # [T, k, E]
    # slot in the expert's queue: every token's rank-0 choice first, then rank 1, ...
    flat = choice.transpose(0, 1).reshape(k * t, e)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(k, t, e).transpose(0, 1)  # [T, k, E]
    keep = (pos < capacity).float() * choice
    # [T, k, C]; a slot past the capacity is all zeros (jax.nn.one_hot's out-of-range row)
    slot = ((pos * choice).sum(-1).long()[..., None] == torch.arange(capacity, device=logits.device)).float()
    dispatch = torch.einsum("tke,tkc->tec", keep, slot)
    combine = torch.einsum("tke,tkc->tec", keep * gate_vals[..., None], slot)
    frac = (choice.sum(1) > 0).float().mean(0)
    aux = e * torch.sum(frac * probs.mean(0))
    return dispatch, combine, aux


def _experts(params: MoEParams, dispatch: torch.Tensor, combine: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    xe = torch.einsum("tec,td->ecd", dispatch.to(xt.dtype), xt)
    h = torch.einsum("ecd,edh->ech", xe, params["w_in"]) + params["b_in"][:, None, :]
    h = F.gelu(h, approximate="tanh")
    ye = torch.einsum("ech,ehd->ecd", h, params["w_out"]) + params["b_out"][:, None, :]
    return torch.einsum("tec,ecd->td", combine.to(xt.dtype), ye)


def moe_apply(params: MoEParams, x: torch.Tensor, k: int = 2, capacity_factor: float = 1.25,
              capacity: Optional[int] = None, mesh: Optional[Mesh] = None,
              axis: str = "expert") -> Tuple[torch.Tensor, torch.Tensor]:
    """Routed expert FFN, residual-free: ``(y, aux_loss)``, ``y`` of ``x``'s
    shape and dtype (leading dims are tokens). With ``mesh`` the experts are
    cut over ``axis``: each position computes its experts' share (its slice
    of ``dispatch`` / ``combine`` and of the expert weights) and the shares
    are summed on ``x``'s device, the same ``y`` on every rank. Across
    processes a rank reads only its own experts' rows of the expert
    weights; when every rank computes the same loss from ``y`` and ``aux``,
    those rows hold the one-process gradient (the other rows zeros), and
    ``x`` and the router the one-process gradient on every rank."""
    shape, w = x.shape, x.shape[-1]
    xt = x.reshape(-1, w)
    e = params["router"]["kernel"].shape[1]
    c = capacity if capacity is not None else _capacity(xt.shape[0], e, k, capacity_factor)
    logits = xt.float() @ params["router"]["kernel"].to(xt.device)
    dispatch, combine, aux = router_dispatch(logits, k, c)
    if mesh is None:
        y = _experts(params, dispatch, combine, xt)
    else:
        row = axis_row(mesh, axis)
        if e % row.size:
            raise ValueError(f"{e} experts do not split over {axis}={row.size}")
        per = e // row.size
        xt_r, dispatch_r, combine_r = (sum_gradients(t, row.group) for t in (xt, dispatch, combine))
        y = None
        for j, dev in row.devices.items():
            sl = slice(j * per, (j + 1) * per)
            share = {n: params[n][sl].to(dev) for n in ("w_in", "b_in", "w_out", "b_out")}
            part = _experts(share, dispatch_r[:, sl].to(dev), combine_r[:, sl].to(dev), xt_r.to(dev)).to(x.device)
            y = part if y is None else y + part
        y = sum_partials(y, row.group)
    return y.reshape(shape).to(x.dtype), aux


def ep_shardings(mesh: Mesh, params: MoEParams, axis: str = "expert") -> Dict[str, Placement]:
    """The expert dim of the expert weights on ``axis`` (inside each process
    or across them); the router replicated."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}: {dict(mesh.shape)}")
    out = {"router.kernel": Placement(mesh, ())}
    for name in ("w_in", "b_in", "w_out", "b_out"):
        out[name] = Placement(mesh, (axis,) + (None,) * (params[name].ndim - 1))
    return out
