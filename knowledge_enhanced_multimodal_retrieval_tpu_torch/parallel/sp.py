"""Sequence parallelism: ring attention over a mesh axis.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/parallel/sp.py``.
Activations are cut along the sequence over a ``seq`` axis; attention, the
only cross-token operation, runs as a ring: each position keeps its query
shard, and after ``t`` hops holds the keys and values of shard
``(me - t) mod n`` (the JAX ``ppermute``), folded into an online softmax in
f32 (running max, numerator, denominator; masked scores ``_NEG = -1e30``,
not ``-inf``, so a fully masked row stays finite). Everything else in a
block is per token (:func:`sp_block_apply`). The JAX package computes this
with einsums and no Pallas kernel, so the port's is plain ``torch.matmul``.

The row of the axis comes from ``parallel.mesh.axis_row``. Where the axis
spans the processes, each rank computes the query shards of its own
positions and reads only its own shards of ``q`` / ``k`` / ``v`` (of ``x``);
a K/V shard whose next position lies on another rank crosses by
``parallel.sharding.exchange``, and the output shards reach every rank
(``sum_partials``). Where another axis spans the processes, each process
runs its own row. The ring is one ``torch.autograd.Function`` whose
backward is the explicit reverse ring of flash attention's backward: each
position recomputes its probabilities from the saved log-sum-exp, keeps
``dQ``, and the ``dK`` / ``dV`` of each K/V shard travel with it around the
ring, home after ``n`` hops.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .mesh import AxisRow, Mesh, axis_row
from .sharding import exchange, sum_gradients, sum_partials

_NEG = -1e30


def _scores(qf: torch.Tensor, kc: torch.Tensor, me: int, src: int, causal: bool) -> torch.Tensor:
    """f32 scores of position ``me``'s (scaled) queries against shard ``src``'s keys."""
    scores = qf @ kc.float().transpose(-1, -2)
    if causal:
        s = qf.shape[2]
        q_pos = me * s + torch.arange(s, device=qf.device)
        k_pos = src * s + torch.arange(s, device=qf.device)
        scores = torch.where((q_pos[:, None] >= k_pos[None, :])[None, None], scores, torch.full_like(scores, _NEG))
    return scores


def _rotate(row: AxisRow, held: Dict[int, List[torch.Tensor]]) -> Dict[int, List[torch.Tensor]]:
    """One hop around the ring: what position ``p`` holds moves to ``p + 1``
    (on its device, or across to its rank)."""
    n, mine = row.size, row.positions
    out, sends, recvs = {}, {}, {}
    for p in mine:
        nxt = (p + 1) % n
        if row.owners[nxt] == row.rank:
            out[nxt] = [t.to(row.devices[nxt]) for t in held[p]]
        else:
            sends[row.owners[nxt]] = held[p]
    first = mine[0]
    prev = (first - 1) % n
    if row.owners[prev] != row.rank:
        out[first] = [torch.empty_like(t, device=row.devices[first]) for t in held[mine[-1]]]
        recvs[row.owners[prev]] = out[first]
    exchange(sends, recvs, row.group)
    return out


class _Ring(torch.autograd.Function):
    """Ring attention over this rank's positions: ``(q_p, k_p, v_p)`` for
    each own position ``p`` (ascending) in, its output shard out."""

    @staticmethod
    def forward(ctx, row: AxisRow, causal: bool, *qkv):
        mine = row.positions
        n, c = row.size, len(mine)
        qs, ks, vs = qkv[:c], qkv[c:2 * c], qkv[2 * c:]
        d = qs[0].shape[-1]
        qf = {p: q.float() * (1.0 / d**0.5) for p, q in zip(mine, qs)}
        state = {p: (torch.full(q.shape[:3], _NEG, dtype=torch.float32, device=q.device),
                     torch.zeros(q.shape, dtype=torch.float32, device=q.device),
                     torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)) for p, q in zip(mine, qs)}
        held = {p: [k, v] for p, k, v in zip(mine, ks, vs)}
        for t in range(n):
            for p in mine:
                kc, vc = held[p]
                scores = _scores(qf[p], kc, p, (p - t) % n, causal)
                m, num, den = state[p]
                m_new = torch.maximum(m, scores.amax(dim=-1))
                alpha = torch.exp(m - m_new)
                prob = torch.exp(scores - m_new[..., None])
                state[p] = (m_new, num * alpha[..., None] + prob @ vc.float(), den * alpha + prob.sum(dim=-1))
            if t < n - 1:
                held = _rotate(row, held)
        outs, lses = [], []
        for p in mine:
            m, num, den = state[p]
            den = torch.clamp(den, min=1e-30)
            outs.append(num / den[..., None])
            lses.append(m + torch.log(den))
        ctx.row, ctx.causal = row, causal
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        return tuple(o.to(q.dtype) for o, q in zip(outs, qs))

    @staticmethod
    def backward(ctx, *g_outs):
        row, causal = ctx.row, ctx.causal
        mine = row.positions
        n, c = row.size, len(mine)
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * c:(i + 1) * c] for i in range(5))
        d = qs[0].shape[-1]
        scale = 1.0 / d**0.5
        qf = {p: q.float() * scale for p, q in zip(mine, qs)}
        g = {p: go.float() for p, go in zip(mine, g_outs)}
        dsum = {p: (g[p] * o).sum(dim=-1) for p, o in zip(mine, outs)}
        lse = dict(zip(mine, lses))
        dq = {p: torch.zeros_like(qf[p]) for p in mine}
        # each K/V shard travels with its gradients' running sums, home after n hops
        held = {p: [k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                    torch.zeros(v.shape, dtype=torch.float32, device=v.device)] for p, k, v in zip(mine, ks, vs)}
        for t in range(n):
            for p in mine:
                kc, vc, dk, dv = held[p]
                prob = torch.exp(_scores(qf[p], kc, p, (p - t) % n, causal) - lse[p][..., None])
                dv += prob.transpose(-1, -2) @ g[p]
                ds = prob * (g[p] @ vc.float().transpose(-1, -2) - dsum[p][..., None])
                dq[p] += ds @ kc.float() * scale
                dk += ds.transpose(-1, -2) @ qf[p]
            # the last hop takes dK / dV home; the keys and values are home already
            held = _rotate(row, held if t < n - 1 else {p: h[2:] for p, h in held.items()})
        return (None, None, *(dq[p].to(q.dtype) for p, q in zip(mine, qs)),
                *(held[p][0].to(k.dtype) for p, k in zip(mine, ks)),
                *(held[p][1].to(v.dtype) for p, v in zip(mine, vs)))


def _ring(row: AxisRow, causal: bool, qs: Dict[int, torch.Tensor], ks: Dict[int, torch.Tensor],
          vs: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
    mine = row.positions
    outs = _Ring.apply(row, causal, *(qs[p] for p in mine), *(ks[p] for p in mine), *(vs[p] for p in mine))
    return dict(zip(mine, outs))


def _gather(row: AxisRow, shards: Dict[int, torch.Tensor], dim: int, like: torch.Tensor) -> torch.Tensor:
    """This rank's output shards in place along ``dim`` (zeros at the other
    ranks' positions), summed over the ranks: the whole result on ``like``'s
    device on every rank."""
    shape = list(next(iter(shards.values())).shape)
    parts = [shards[p].to(like.device) if p in shards else like.new_zeros(shape) for p in range(row.size)]
    return sum_partials(torch.cat(parts, dim=dim), row.group)


def _check_divisible(length: int, row: AxisRow) -> int:
    if length % row.size:
        raise ValueError(f"sequence {length} not divisible by {row.axis}={row.size}")
    return length // row.size


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, axis: str = "seq",
                   causal: bool = False) -> torch.Tensor:
    """Sequence-sharded attention with ``ops.attention.mha``'s semantics:
    ``q, k, v`` ``[B, H, S, D]``, ``S`` divisible by the axis size; the
    result on ``q``'s device, the same on every rank. Across processes each
    rank reads only its own sequence shards of ``q``, ``k`` and ``v``; when
    every rank computes the same loss from the result, each rank's own
    shards of their gradients hold the one-process gradient, the others
    zeros."""
    row = axis_row(mesh, axis)
    s = _check_divisible(q.shape[2], row)

    def cut(x):
        return {p: x[:, :, p * s:(p + 1) * s].to(dev) for p, dev in row.devices.items()}

    return _gather(row, _ring(row, causal, cut(q), cut(k), cut(v)), 2, q)


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
    layout). The result on ``x``'s device, the same on every rank. Across
    processes each rank reads only its own shards of ``x``; when every rank
    computes the same loss from the result, ``block_params`` holds the
    one-process gradient on every rank and ``x`` in the rank's own shards
    (zeros in the others)."""
    row = axis_row(mesh, axis)
    s = _check_divisible(x.shape[1], row)
    params = {k: sum_gradients(v, row.group) for k, v in block_params.items()}
    xs = {p: x[:, p * s:(p + 1) * s].to(dev) for p, dev in row.devices.items()}

    def on(name, dev):
        return params[name].to(dev)

    def heads_first(t: torch.Tensor) -> torch.Tensor:
        b, s_, w = t.shape
        return t.reshape(b, s_, heads, w // heads).transpose(1, 2)

    qkv = {p: [heads_first(part) for part in _dense(
        _layernorm_f32(xl, on("ln_1.weight", xl.device), on("ln_1.bias", xl.device)),
        on("attn.in_proj_weight", xl.device), on("attn.in_proj_bias", xl.device)).chunk(3, dim=-1)]
        for p, xl in xs.items()}
    att = _ring(row, causal, *({p: t[i] for p, t in qkv.items()} for i in range(3)))
    outs = {}
    for p, xl in xs.items():
        dev = xl.device
        a = att[p]
        b, h, s_, d = a.shape
        xl = xl + _dense(a.transpose(1, 2).reshape(b, s_, h * d), on("attn.out_proj.weight", dev),
                         on("attn.out_proj.bias", dev))
        hid = _dense(_layernorm_f32(xl, on("ln_2.weight", dev), on("ln_2.bias", dev)), on("mlp.c_fc.weight", dev),
                     on("mlp.c_fc.bias", dev))
        hid = hid * torch.sigmoid(1.702 * hid)  # QuickGELU
        outs[p] = xl + _dense(hid, on("mlp.c_proj.weight", dev), on("mlp.c_proj.bias", dev))
    return _gather(row, outs, 1, x)
