"""CLIP (Radford et al. 2021) in plain PyTorch, float32, from its published
description: a class-token ViT over patches and a causal text transformer,
pre-LayerNorm residual blocks with fused qkv and QuickGELU, EOT pooling, a
linear projection of each tower. Weights are a dict in OpenAI's layout
(the text tower's under ``text.``).

Two ways of computing the products stand in for a program's precision:

- ``Quant(bits)``: W{bits}A{bits} dynamic quantization of the four block
  projections, as a serving int8 plan states it (weights symmetric per
  output channel, activations symmetric per row, the MLP's hidden
  activations per row within groups of ``ff_group`` columns), products of
  the integer values exact in float64. ``bits=8`` is the program's int8
  scheme worked out again; ``bits=4`` its control.
- ``Floats(fmt)``: every product of the towers with its operands rounded
  to ``fmt`` (per-tensor scaled float8 in the forward and in the
  backward), the rest float32: the control of a bf16 training step.

The caller turns TF32 off; nothing here reads or imports the program.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

W = Dict[str, torch.Tensor]


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x: torch.Tensor, w: W, name: str) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w[name + ".weight"], w[name + ".bias"], 1e-5)


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------


class Exact:
    """float32 products: ``linear(x, weight [out, in], bias)`` and ``bmm``."""

    def linear(self, x, weight, bias, group: Optional[int] = None):
        return F.linear(x, weight, bias)

    def bmm(self, a, b):
        return a @ b


def quantize_sym(x: torch.Tensor, bits: int, dim: int) -> tuple:
    """Symmetric integer values and scales along ``dim`` (max |x| -> 2^(bits-1) - 1)."""
    top = 2 ** (bits - 1) - 1
    s = (x.abs().amax(dim=dim, keepdim=True) / top).clamp_min(1e-12)
    return torch.round(x / s).clamp(-top, top), s


class Quant(Exact):
    def __init__(self, bits: int, ff_group: int):
        self.bits, self.ff_group = bits, ff_group

    def linear(self, x, weight, bias, group: Optional[int] = None):
        wq, ws = quantize_sym(weight, self.bits, dim=1)  # per output channel: weight is [out, in]
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        g = group or shape[-1]
        out = torch.zeros(x.shape[0], weight.shape[0], dtype=torch.float64, device=x.device)
        for start in range(0, shape[-1], g):
            xq, xs = quantize_sym(x[:, start:start + g], self.bits, dim=1)
            out += (xq.double() @ wq[:, start:start + g].double().t()) * xs.double()
        y = (out * ws.double().t()).float() + bias
        return y.reshape(*shape[:-1], weight.shape[0])


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, fwd, bwd):
        ctx.save_for_backward(a, b)
        ctx.rnd = (fwd, bwd)
        return fwd(a) @ fwd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        fwd, bwd = ctx.rnd
        g = bwd(g)
        return g @ fwd(b).transpose(-1, -2), fwd(a).transpose(-1, -2) @ g, None, None


def round_scaled(fmt: torch.dtype) -> Callable[[torch.Tensor], torch.Tensor]:
    """Round to ``fmt`` after scaling the tensor's largest magnitude to the
    format's largest finite value (float8's usual per-tensor scale)."""
    top = torch.finfo(fmt).max

    def rnd(x: torch.Tensor) -> torch.Tensor:
        s = (x.detach().abs().amax() / top).clamp_min(1e-30)
        return (x / s).to(fmt).float() * s

    return rnd


class Floats(Exact):
    """Products with operands rounded: e4m3 forward, e5m2 gradients."""

    def __init__(self, fwd: torch.dtype = torch.float8_e4m3fn, bwd: torch.dtype = torch.float8_e5m2):
        self.fwd, self.bwd = round_scaled(fwd), round_scaled(bwd)

    def bmm(self, a, b):
        return _RoundedMatmul.apply(a, b, self.fwd, self.bwd)

    def linear(self, x, weight, bias, group: Optional[int] = None):
        return self.bmm(x, weight.t()) + bias


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------


def attention(x: torch.Tensor, w: W, p: str, heads: int, causal: bool, mm: Exact) -> torch.Tensor:
    b, s, width = x.shape
    qkv = mm.linear(x, w[p + ".in_proj_weight"], w[p + ".in_proj_bias"])
    q, k, v = qkv.view(b, s, 3, heads, width // heads).permute(2, 0, 3, 1, 4)
    scores = mm.bmm(q, k.transpose(-1, -2)) * (width // heads) ** -0.5
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    o = mm.bmm(torch.softmax(scores, dim=-1), v)
    return mm.linear(o.transpose(1, 2).reshape(b, s, width), w[p + ".out_proj.weight"], w[p + ".out_proj.bias"])


def block(x: torch.Tensor, w: W, p: str, heads: int, causal: bool, mm: Exact) -> torch.Tensor:
    x = x + attention(layer_norm(x, w, p + ".ln_1"), w, p + ".attn", heads, causal, mm)
    h = quick_gelu(mm.linear(layer_norm(x, w, p + ".ln_2"), w[p + ".mlp.c_fc.weight"], w[p + ".mlp.c_fc.bias"]))
    group = getattr(mm, "ff_group", None)
    return x + mm.linear(h, w[p + ".mlp.c_proj.weight"], w[p + ".mlp.c_proj.bias"], group=group)


def transformer(x, w: W, prefix: str, layers: int, heads: int, causal: bool, mm: Exact, remat: bool):
    for i in range(layers):
        p = f"{prefix}.transformer.resblocks.{i}"
        if remat and torch.is_grad_enabled():
            x = checkpoint(block, x, w, p, heads, causal, mm, use_reentrant=False)
        else:
            x = block(x, w, p, heads, causal, mm)
    return x


def encode_text(w: W, ids: torch.Tensor, a, mm: Exact = Exact(), remat: bool = False) -> torch.Tensor:
    """ids [B, S] -> L2-normalized [B, E]; pooled at each row's EOT (its
    largest id)."""
    s = ids.shape[1]
    x = w["text.token_embedding.weight"][ids] + w["text.positional_embedding"][:s]
    x = transformer(x, w, "text", a.text_layers, a.text_heads, True, mm, remat)
    x = layer_norm(x[torch.arange(ids.shape[0], device=ids.device), ids.argmax(dim=-1)], w, "text.ln_final")
    return F.normalize(mm.bmm(x, w["text.text_projection"]), dim=-1)


def encode_image(w: W, images: torch.Tensor, a, mm: Exact = Exact(), remat: bool = False) -> torch.Tensor:
    """images [B, H, W, 3] (normalized pixels) -> L2-normalized [B, E]."""
    b, p = images.shape[0], a.vision_patch_size
    g = a.grid_size
    patches = images.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 5, 2, 4).reshape(b, g * g, 3 * p * p)
    x = mm.bmm(patches, w["visual.conv1.weight"].reshape(w["visual.conv1.weight"].shape[0], -1).t())
    cls = w["visual.class_embedding"].expand(b, 1, -1)
    x = torch.cat([cls, x], dim=1) + w["visual.positional_embedding"]
    x = layer_norm(x, w, "visual.ln_pre")
    x = transformer(x, w, "visual", a.vision_layers, a.vision_heads, False, mm, remat)
    x = layer_norm(x[:, 0], w, "visual.ln_post")
    return F.normalize(mm.bmm(x, w["visual.proj"]), dim=-1)
