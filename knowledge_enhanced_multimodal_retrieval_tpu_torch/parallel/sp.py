"""Sequence parallelism: ring attention over a mesh axis.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/parallel/sp.py``.
Activations are cut along the sequence over a ``seq`` axis; attention, the
only cross-token operation, runs as a ring: each shard keeps its queries,
and after ``t`` hops holds the keys and values of shard ``(me - t) mod n``
(moved with ``.to``, the JAX ``ppermute``), folded into an online softmax in
f32 (running max, numerator, denominator; masked scores ``_NEG = -1e30``,
not ``-inf``, so a fully masked row stays finite). Everything else in a
block is per token (:func:`sp_block_apply`). The JAX package computes this
with einsums and no Pallas kernel, so the port's is plain ``torch.matmul``;
the axis lies inside one process (``parallel.pp.local_axis_devices``).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .mesh import Mesh
from .pp import local_axis_devices

_NEG = -1e30


def _ring_local(qs: List[torch.Tensor], ks: List[torch.Tensor], vs: List[torch.Tensor], me: int,
                devs: List[torch.device], causal: bool) -> torch.Tensor:
    """Shard ``me``'s output ``[B, H, s, D]`` from its queries and the ring's K/V shards."""
    n = len(devs)
    q = qs[me]
    b, h, s, d = q.shape
    dev = devs[me]
    qf = q.float() * (1.0 / d**0.5)
    q_pos = me * s + torch.arange(s, device=dev)
    m = torch.full((b, h, s), _NEG, dtype=torch.float32, device=dev)
    num = torch.zeros((b, h, s, d), dtype=torch.float32, device=dev)
    den = torch.zeros((b, h, s), dtype=torch.float32, device=dev)
    for t in range(n):
        src = (me - t) % n  # after t hops this shard holds src's keys and values
        kc, vc = ks[src].to(dev), vs[src].to(dev)
        scores = qf @ kc.float().transpose(-1, -2)
        if causal:
            k_pos = src * s + torch.arange(s, device=dev)
            scores = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None], scores,
                                 torch.full_like(scores, _NEG))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        num = num * alpha[..., None] + p @ vc.float()
        den = den * alpha + p.sum(dim=-1)
        m = m_new
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)


def _shards(x: torch.Tensor, dim: int, devs: List[torch.device]) -> List[torch.Tensor]:
    return [c.to(d) for c, d in zip(x.chunk(len(devs), dim=dim), devs)]


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, axis: str = "seq",
                   causal: bool = False) -> torch.Tensor:
    """Sequence-sharded attention with ``ops.attention.mha``'s semantics:
    ``q, k, v`` ``[B, H, S, D]``, ``S`` divisible by the axis size; the
    result on ``q``'s device."""
    devs = local_axis_devices(mesh, axis)
    n = len(devs)
    if q.shape[2] % n:
        raise ValueError(f"sequence {q.shape[2]} not divisible by {axis}={n}")
    qs, ks, vs = (_shards(t, 2, devs) for t in (q, k, v))
    return torch.cat([_ring_local(qs, ks, vs, me, devs, causal).to(q.device) for me in range(n)], dim=2)


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w.T + b`` for the port's ``[out, in]`` weights, in ``x``'s dtype."""
    return x @ w.to(x.dtype).T + b.to(x.dtype)


def _layernorm_f32(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) / torch.sqrt(var + eps) * w + b).to(x.dtype)


def sp_block_apply(block_params: Dict[str, torch.Tensor], x: torch.Tensor, mesh: Mesh, heads: int,
                   axis: str = "seq", causal: bool = False) -> torch.Tensor:
    """One CLIP ``ResidualBlock`` (pre-LN, fused qkv, QuickGELU) with
    ``x`` ``[B, S, W]`` cut along the sequence: everything per token on its
    shard, attention through the ring. ``block_params``: the block's state
    dict (``ln_1.weight``, ``attn.in_proj_weight``, ... in the ``[out, in]``
    layout). The result on ``x``'s device."""
    devs = local_axis_devices(mesh, axis)
    n = len(devs)
    if x.shape[1] % n:
        raise ValueError(f"sequence {x.shape[1]} not divisible by {axis}={n}")
    p = block_params
    xs = _shards(x, 1, devs)

    def heads_first(t: torch.Tensor) -> torch.Tensor:
        b, s, w = t.shape
        return t.reshape(b, s, heads, w // heads).transpose(1, 2)

    qkv = [_dense(_layernorm_f32(xl, p["ln_1.weight"].to(xl.device), p["ln_1.bias"].to(xl.device)),
                  p["attn.in_proj_weight"].to(xl.device), p["attn.in_proj_bias"].to(xl.device)).chunk(3, dim=-1)
           for xl in xs]
    qs, ks, vs = ([heads_first(part[i]) for part in qkv] for i in range(3))
    outs = []
    for me, xl in enumerate(xs):
        on = lambda name: p[name].to(xl.device)  # noqa: E731
        a = _ring_local(qs, ks, vs, me, devs, causal)
        b, h, s, d = a.shape
        xl = xl + _dense(a.transpose(1, 2).reshape(b, s, h * d), on("attn.out_proj.weight"), on("attn.out_proj.bias"))
        hid = _dense(_layernorm_f32(xl, on("ln_2.weight"), on("ln_2.bias")), on("mlp.c_fc.weight"), on("mlp.c_fc.bias"))
        hid = hid * torch.sigmoid(1.702 * hid)  # QuickGELU
        outs.append((xl + _dense(hid, on("mlp.c_proj.weight"), on("mlp.c_proj.bias"))).to(x.device))
    return torch.cat(outs, dim=1)
