"""Learned fusion heads combining T2I and T2T evidence, as ``nn.Module``s.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/models/fusion_heads.py``,
the same six architectures and initializations:

- ``LinearFusionHead``          — MLP over stacked [t2i, t2t] scores
- ``CrossAttentionFusionHead``  — per-pair query attends over {image, target},
  tanh-bounded to [-0.5, 0.5]
- ``GatedFusionHead``           — query-conditioned sigmoid gate MLP
- ``SimpleGatedFusion``         — linear gate, weight ones, bias 0
- ``SimpleGatedFusionWithBias`` — weight zeros, bias -2 (gate ~ 0.12)
- ``BilinearFusionHead``        — per-modality projections + a learnable
  sigmoid-constrained alpha (0.5 before the sigmoid)

Dense layers draw flax's default initialization (LeCun normal over the
fan-in, truncated at two standard deviations; zero biases) from an explicit
``torch.Generator``; dropout masks come from an explicit generator too, and
a head runs deterministic when it is given none. The cross-attention head
keeps its own query / key / value / out ``Linear``s (flax's
``MultiHeadDotProductAttention`` layout, scaled by 1/sqrt(D/H)).

Weights carried across: :func:`fusion_params_from_flax` maps a flax
parameter tree, flattened with ``/`` (the fusion-head artifact's
``param:<path>`` keys), to a state dict, and :func:`fusion_params_to_flax`
maps it back, both on NumPy. ``FusionModel`` routes score-based and
embedding-based heads; its ``params`` is the head module.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

FUSION_TYPES = (
    "linear",
    "cross_attention",
    "gated",
    "simple_gated",
    "simple_gated_with_bias",
    "bilinear",
)

# Heads whose forward consumes precomputed score matrices rather than embeddings.
SCORE_BASED = ("linear",)

CROSS_ATTENTION_HEADS = 8  # build_head's num_heads for the cross-attention head

_TRUNC_NORMAL_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal truncated to two standard deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_NORMAL_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def _dense(n_in: int, n_out: int, generator: torch.Generator, bias: bool = True) -> nn.Linear:
    lin = nn.Linear(n_in, n_out, bias=bias)
    lecun_normal_(lin.weight, n_in, generator)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator], shape=None) -> torch.Tensor:
    """flax's ``Dropout``: keep with probability ``1 - rate`` and scale by its
    inverse; the identity without a generator (deterministic). ``shape``
    draws a smaller mask that broadcasts over ``x``."""
    if generator is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape if shape is None else shape, generator=generator, device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


class LinearFusionHead(nn.Module):
    """MLP on stacked [t2i, t2t] score pairs."""

    def __init__(self, generator: torch.Generator, hidden_dim: int = 128, dropout: float = 0.1):
        super().__init__()
        self.fc1 = _dense(2, hidden_dim, generator)
        self.fc2 = _dense(hidden_dim, 1, generator)
        self.rate = dropout

    def forward(self, t2i_sim, t2t_sim, generator=None):
        x = torch.stack([t2i_sim, t2t_sim], dim=-1)  # [N, M, 2]
        x = torch.relu(self.fc1(x))
        x = dropout(x, self.rate, generator)
        return self.fc2(x).squeeze(-1)


class CrossAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` for one query token over a few
    key/value tokens: q / k / v projections to [H, D/H], softmax of
    q.k / sqrt(D/H), dropout on the weights (one mask over the keys, shared
    by every pair and head: flax's ``broadcast_dropout``) and the out
    projection."""

    def __init__(self, dim: int, heads: int, generator: torch.Generator, dropout: float = 0.1):
        super().__init__()
        self.heads, self.rate = heads, dropout
        self.query = _dense(dim, dim, generator)
        self.key = _dense(dim, dim, generator)
        self.value = _dense(dim, dim, generator)
        self.out = _dense(dim, dim, generator)

    def forward(self, q, kv, generator=None):
        """``q [..., D]`` attends over ``kv [..., T, D]`` -> ``[..., D]``."""
        h = self.heads
        d = q.shape[-1] // h
        qh = self.query(q).unflatten(-1, (h, d)) / math.sqrt(d)  # [..., H, d]
        kh = self.key(kv).unflatten(-1, (h, d))  # [..., T, H, d]
        vh = self.value(kv).unflatten(-1, (h, d))
        logits = torch.einsum("...hd,...thd->...ht", qh, kh)
        w = dropout(torch.softmax(logits, dim=-1), self.rate, generator, shape=logits.shape[-1:])
        o = torch.einsum("...ht,...thd->...hd", w, vh)
        return self.out(o.flatten(-2))


class CrossAttentionFusionHead(nn.Module):
    """Per-pair cross-attention over {image, target}."""

    def __init__(self, generator: torch.Generator, embed_dim: int = 768, num_heads: int = 8,
                 hidden_dim: int = 256, dropout: float = 0.1):
        super().__init__()
        d = embed_dim
        self.query_proj = _dense(d, d, generator)
        self.image_proj = _dense(d, d, generator)
        self.target_proj = _dense(d, d, generator)
        self.cross_attn = CrossAttention(d, num_heads, generator, dropout)
        self.mlp1 = _dense(d, hidden_dim, generator)
        self.mlp2 = _dense(hidden_dim, 64, generator)
        self.mlp3 = _dense(64, 1, generator)
        self.rate = dropout

    def forward(self, query_embed, image_embed, target_embed, generator=None):
        n, m = query_embed.shape[0], image_embed.shape[0]
        q = self.query_proj(query_embed)  # [N, D]
        i = self.image_proj(image_embed)  # [M, D]
        t = self.target_proj(target_embed)
        # every pair: the query token attends over its pair's {image, target} tokens
        q_pairs = q[:, None, :].expand(n, m, q.shape[-1])
        kv = torch.stack([i, t], dim=1)[None].expand(n, m, 2, q.shape[-1])
        x = self.cross_attn(q_pairs, kv, generator)  # [N, M, D]
        x = dropout(torch.relu(self.mlp1(x)), self.rate, generator)
        x = dropout(torch.relu(self.mlp2(x)), self.rate, generator)
        x = self.mlp3(x).squeeze(-1)
        return torch.tanh(x) * 0.5


class GatedFusionHead(nn.Module):
    """Query-conditioned sigmoid gate over T2I/T2T."""

    def __init__(self, generator: torch.Generator, embed_dim: int = 768, dropout: float = 0.1):
        super().__init__()
        self.gate1 = _dense(embed_dim, 128, generator)
        self.gate2 = _dense(128, 1, generator)
        self.rate = dropout

    def forward(self, query_embed, image_embed, target_embed, generator=None):
        t2i = query_embed @ image_embed.T
        t2t = query_embed @ target_embed.T
        g = dropout(torch.relu(self.gate1(query_embed)), self.rate, generator)
        gate = torch.sigmoid(self.gate2(g))  # [N, 1]
        return gate * t2i + (1 - gate) * t2t


class SimpleGatedFusion(nn.Module):
    """Linear gate: weight ones, bias 0."""

    def __init__(self, generator: Optional[torch.Generator] = None, embed_dim: int = 768):
        super().__init__()
        self.query_weight = nn.Parameter(torch.ones(embed_dim))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, query_embed, image_embed, target_embed, generator=None):
        t2i = query_embed @ image_embed.T
        t2t = query_embed @ target_embed.T
        gate = torch.sigmoid(torch.sum(query_embed * self.query_weight, dim=1, keepdim=True) + self.bias)
        return gate * t2i + (1 - gate) * t2t


class SimpleGatedFusionWithBias(SimpleGatedFusion):
    """Weight zeros, bias -2, so the gate starts near 0.12."""

    def __init__(self, generator: Optional[torch.Generator] = None, embed_dim: int = 768):
        super().__init__(generator, embed_dim)
        self.query_weight = nn.Parameter(torch.zeros(embed_dim))
        self.bias = nn.Parameter(torch.tensor(-2.0))


class BilinearFusionHead(nn.Module):
    """Learned per-modality projections + sigmoid alpha."""

    def __init__(self, generator: torch.Generator, embed_dim: int = 768):
        super().__init__()
        self.W_image = _dense(embed_dim, embed_dim, generator, bias=False)
        self.W_target = _dense(embed_dim, embed_dim, generator, bias=False)
        self.alpha = nn.Parameter(torch.tensor(0.5))

    def forward(self, query_embed, image_embed, target_embed, generator=None):
        img_p = self.W_image(image_embed)
        tgt_p = self.W_target(target_embed)
        alpha = torch.sigmoid(self.alpha)
        return alpha * (query_embed @ img_p.T) + (1 - alpha) * (query_embed @ tgt_p.T)


def build_head(fusion_type: str, embed_dim: int = 768, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Head factory with seeded weights (``generator``, seed 0 without one)."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    if fusion_type == "linear":
        return LinearFusionHead(g, hidden_dim=128)
    if fusion_type == "cross_attention":
        return CrossAttentionFusionHead(g, embed_dim=embed_dim, num_heads=CROSS_ATTENTION_HEADS, hidden_dim=256)
    if fusion_type == "gated":
        return GatedFusionHead(g, embed_dim=embed_dim)
    if fusion_type == "simple_gated":
        return SimpleGatedFusion(g, embed_dim=embed_dim)
    if fusion_type == "simple_gated_with_bias":
        return SimpleGatedFusionWithBias(g, embed_dim=embed_dim)
    if fusion_type == "bilinear":
        return BilinearFusionHead(g, embed_dim=embed_dim)
    raise ValueError(f"Unknown fusion type: {fusion_type}")


# ---------------------------------------------------------------------------
# weights carried across: flax parameter paths <-> state dicts (NumPy)
# ---------------------------------------------------------------------------

_MHA = "cross_attn/"


def fusion_params_from_flax(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """A flax head's parameters, flattened with ``/``, as the port's state
    dict: Dense kernels ``[in, out]`` become ``Linear`` weights ``[out, in]``;
    the attention's ``[D, H, D/H]`` q/k/v kernels and ``[H, D/H]`` biases
    flatten their head axes, its ``[H, D/H, D]`` out kernel its first two."""
    sd: Dict[str, np.ndarray] = {}
    for path, v in flat.items():
        v = np.asarray(v)
        if path.endswith("/kernel"):
            if path.startswith(_MHA) and v.ndim == 3:
                v = v.reshape(-1, v.shape[-1]) if path == f"{_MHA}out/kernel" else v.reshape(v.shape[0], -1)
            v = v.T
        elif path.startswith(_MHA) and path.endswith("/bias") and v.ndim == 2:
            v = v.reshape(-1)
        key = path.replace("/", ".")
        sd[key[: -len("kernel")] + "weight" if key.endswith(".kernel") else key] = np.array(v, order="C")
    return sd


def fusion_params_to_flax(state_dict: Mapping[str, np.ndarray], num_heads: int = CROSS_ATTENTION_HEADS
                          ) -> Dict[str, np.ndarray]:
    """The inverse of :func:`fusion_params_from_flax`, in flax's key order."""
    flat: Dict[str, np.ndarray] = {}
    for key, v in state_dict.items():
        v = np.asarray(v)
        path = key.replace(".", "/")
        if path.endswith("/weight"):
            path = path[: -len("weight")] + "kernel"
            v = v.T
            if path.startswith(_MHA):
                d = v.shape[0]
                v = v.reshape(num_heads, d // num_heads, d) if path == f"{_MHA}out/kernel" else \
                    v.reshape(d, num_heads, d // num_heads)
        elif path.startswith(_MHA) and path.endswith("/bias") and path != f"{_MHA}out/bias":
            v = v.reshape(num_heads, -1)
        flat[path] = np.array(v, order="C")
    # flax's creation order: a head's sub-layers come before its own
    # parameters (the bilinear head's alpha), where a state dict lists its own first
    return dict(sorted(flat.items(), key=lambda kv: "/" not in kv[0]))


def head_state_numpy(params: nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in params.state_dict().items()}


class FusionModel:
    """A fusion head over frozen CLIP embeddings (L2-normalized upstream);
    routes score-based and embedding-based heads. ``params`` in every method
    is the head module that :meth:`init` (or the trainer, or
    ``train.fusion_trainer.load_fusion_head``) gives."""

    def __init__(self, fusion_type: str, embed_dim: int = 768):
        if fusion_type not in FUSION_TYPES:
            raise ValueError(f"Unknown fusion type: {fusion_type}")
        self.fusion_type = fusion_type
        self.embed_dim = embed_dim

    def init(self, generator: Union[torch.Generator, int] = 0, device=None) -> nn.Module:
        """A head with seeded weights (drawn on the CPU, then moved)."""
        g = generator if isinstance(generator, torch.Generator) else torch.Generator().manual_seed(int(generator))
        head = build_head(self.fusion_type, self.embed_dim, g)
        return head.to(device) if device is not None else head

    def from_flax(self, flat: Mapping[str, np.ndarray], device=None) -> nn.Module:
        """A head holding a flax parameter tree's values (flattened with ``/``)."""
        head = self.init(0)
        sd = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in fusion_params_from_flax(flat).items()}
        head.load_state_dict(sd)
        return head.to(device) if device is not None else head

    def scores(self, params: nn.Module, query_embed, image_embed, target_embed, deterministic: bool = True,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``[N, D] x [M, D]² -> [N, M]`` fused scores; dropout draws from
        ``generator`` when not ``deterministic``."""
        g = None if deterministic else generator
        if self.fusion_type in SCORE_BASED:
            t2i = query_embed @ image_embed.T
            t2t = query_embed @ target_embed.T
            return params(t2i, t2t, g)
        return params(query_embed, image_embed, target_embed, g)

    @torch.no_grad()
    def candidate_scores(self, params: nn.Module, query_embed, image_embed, target_embed) -> torch.Tensor:
        """Per-query candidate rescoring: ``[Q, D] x [Q, R, D]² -> [Q, R]``,
        each query scored against only its own candidates: :meth:`scores`
        with a one-row query block, mapped over the queries in one batched
        call (``torch.vmap``)."""

        def one(q1, i1, t1):
            return self.scores(params, q1[None, :], i1, t1)[0]

        return torch.vmap(one)(query_embed, image_embed, target_embed)

    @torch.no_grad()
    def blockwise_scores(self, params: nn.Module, query_embed, image_embed, target_embed, block_q: int = 64,
                         block_c: int = 512) -> torch.Tensor:
        """The full [N, M] fused matrix in ``block_q`` x ``block_c`` tiles."""
        n, m = query_embed.shape[0], image_embed.shape[0]
        rows = []
        for qs in range(0, n, block_q):
            q = query_embed[qs : qs + block_q]
            rows.append(torch.cat([
                self.scores(params, q, image_embed[cs : cs + block_c], target_embed[cs : cs + block_c])
                for cs in range(0, m, block_c)
            ], dim=1))
        return torch.cat(rows, dim=0)
