"""CLIP text tower in PyTorch.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/models/clip.py``:
``CLIPArch``/``ARCHS``, ``quick_gelu``, ``l2_normalize`` and the causal
text transformer (pre-LN in f32, fused qkv in_proj, QuickGELU MLP, EOT
pooling at ``argmax(ids)``, learned projection). Parameters keep OpenAI's
``clip`` state-dict names and layouts, so an OpenAI text state dict loads
with ``load_state_dict``. The tower is the port's ``encoder=flax`` mode and
the f32 oracle for the serving encoder; the vision tower is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class CLIPArch:
    """Architecture hyperparameters of one CLIP variant."""

    embed_dim: int
    image_resolution: int
    vision_layers: int
    vision_width: int
    vision_patch_size: int
    context_length: int
    vocab_size: int
    text_width: int
    text_heads: int
    text_layers: int
    vision_heads: int = 0  # 0 = auto (width // 64, the OpenAI convention)

    @property
    def heads_vision(self) -> int:
        return self.vision_heads or self.vision_width // 64

    @property
    def grid_size(self) -> int:
        return self.image_resolution // self.vision_patch_size


ARCHS = {
    "ViT-B/32": CLIPArch(512, 224, 12, 768, 32, 77, 49408, 512, 8, 12),
    "ViT-B/16": CLIPArch(512, 224, 12, 768, 16, 77, 49408, 512, 8, 12),
    "ViT-L/14": CLIPArch(768, 224, 24, 1024, 14, 77, 49408, 768, 12, 12),
    "ViT-L/14@336px": CLIPArch(768, 336, 24, 1024, 14, 77, 49408, 768, 12, 12),
}


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """QuickGELU: x * sigmoid(1.702 x) — OpenAI CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def _ln_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in f32, cast back to the compute dtype."""
    return nn.functional.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps).to(x.dtype)


class MultiheadSelfAttention(nn.Module):
    """Fused-qkv self-attention in OpenAI's layout (``in_proj_weight`` [3W, W])."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        b, s, w = x.shape
        dt = x.dtype
        qkv = nn.functional.linear(x, self.in_proj_weight.to(dt), self.in_proj_bias.to(dt))
        q, k, v = qkv.view(b, s, 3, self.heads, w // self.heads).permute(2, 0, 3, 1, 4)
        logits = (q @ k.transpose(-1, -2)).float() / math.sqrt(w // self.heads)
        if causal:
            keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~keep, torch.finfo(torch.float32).min)
        p = torch.softmax(logits, dim=-1).to(dt)
        out = (p @ v).transpose(1, 2).reshape(b, s, w)
        return nn.functional.linear(out, self.out_proj.weight.to(dt), self.out_proj.bias.to(dt))


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        h = quick_gelu(nn.functional.linear(x, self.c_fc.weight.to(dt), self.c_fc.bias.to(dt)))
        return nn.functional.linear(h, self.c_proj.weight.to(dt), self.c_proj.bias.to(dt))


class ResidualBlock(nn.Module):
    """Pre-LN residual attention block (OpenAI ``ResidualAttentionBlock``)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiheadSelfAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = MLP(width)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        x = x + self.attn(_ln_f32(self.ln_1, x), causal)
        return x + self.mlp(_ln_f32(self.ln_2, x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.ModuleList(ResidualBlock(width, heads) for _ in range(layers))

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, causal)
        return x


class TextTransformer(nn.Module):
    """CLIP's causal text tower: ids [B, S] -> [B, embed_dim] f32 (unnormalized).

    Parameters stay f32; ``dtype`` is the compute dtype (as the flax
    module's), with LayerNorm and softmax in f32."""

    def __init__(self, arch: CLIPArch, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        w = arch.text_width
        self.token_embedding = nn.Embedding(arch.vocab_size, w)
        self.positional_embedding = nn.Parameter(torch.empty(arch.context_length, w))
        self.transformer = Transformer(w, arch.text_layers, arch.text_heads)
        self.ln_final = nn.LayerNorm(w)
        self.text_projection = nn.Parameter(torch.empty(w, arch.embed_dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        s = ids.shape[1]
        x = self.token_embedding.weight.to(dt)[ids] + self.positional_embedding[:s].to(dt)
        x = self.transformer(x, causal=True)
        x = _ln_f32(self.ln_final, x)
        x = x[torch.arange(ids.shape[0], device=ids.device), ids.argmax(dim=-1)]
        return (x @ self.text_projection.to(dt)).float()


def init_text_weights(model: TextTransformer, seed: int = 0) -> TextTransformer:
    """Seeded random weights in place (the flax init's scales: lecun-normal
    projections, zero biases, unit LayerNorms, 0.01 positions). Drawn on the
    CPU with a ``torch.Generator``, so a seed gives the same weights on
    every device."""
    g = torch.Generator().manual_seed(seed)
    w = model.arch.text_width

    def normal(p: torch.Tensor, std: float) -> None:
        p.data.copy_(torch.randn(p.shape, generator=g) * std)

    with torch.no_grad():
        normal(model.token_embedding.weight, w**-0.5)
        normal(model.positional_embedding, 0.01)
        normal(model.text_projection, w**-0.5)
        for blk in model.transformer.resblocks:
            normal(blk.attn.in_proj_weight, w**-0.5)
            normal(blk.attn.out_proj.weight, w**-0.5)
            normal(blk.mlp.c_fc.weight, w**-0.5)
            normal(blk.mlp.c_proj.weight, (4 * w) ** -0.5)
            for p in (blk.attn.in_proj_bias, blk.attn.out_proj.bias, blk.mlp.c_fc.bias, blk.mlp.c_proj.bias):
                p.zero_()
            for ln in (blk.ln_1, blk.ln_2):
                ln.weight.fill_(1.0)
                ln.bias.zero_()
        model.ln_final.weight.fill_(1.0)
        model.ln_final.bias.zero_()
    return model


def build_text_model(
    name: str, dtype: torch.dtype = torch.bfloat16, seed: int = 0, device=None,
    arch: Optional[CLIPArch] = None,
) -> TextTransformer:
    """A text tower for ``ARCHS[name]`` (or ``arch``) with seeded weights."""
    if arch is None:
        if name not in ARCHS:
            raise ValueError(f"unknown CLIP variant {name!r}; available: {sorted(ARCHS)}")
        arch = ARCHS[name]
    model = init_text_weights(TextTransformer(arch, dtype), seed)
    return model.to(device) if device is not None else model
