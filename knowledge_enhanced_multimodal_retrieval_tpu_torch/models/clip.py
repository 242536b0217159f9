"""CLIP in PyTorch: ViT image tower + causal text transformer.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/models/clip.py``:
``CLIPArch``/``ARCHS``, ``quick_gelu``, ``l2_normalize``, the class-token
ViT (NHWC images, patch conv without bias, pre-LN in f32, bidirectional
attention, ``ln_post`` on the class token, learned projection), the causal
text transformer (EOT pooling at ``argmax(ids)``) and the ``CLIP``
container with ``logit_scale``. Each tower keeps OpenAI's ``clip``
state-dict names and layouts (the vision tower's under ``visual.``), so
``models.convert`` loads an OpenAI state dict with ``load_state_dict``.
The towers are the port's ``encoder=flax`` mode and the f32 oracle for the
serving encoders. Parameters stay f32; ``dtype`` is the compute dtype,
with LayerNorm and softmax in f32. Attention goes through ``ops.attention.mha``:
the hand-written kernel (B6/B7) for every CUDA tensor whatever its length
(both towers), the plain version for a CPU tensor; its gradient recomputes
through the plain version. Training adds FLIP patch subsets (``keep_idx``)
and ``remat``, which recomputes each residual block in the backward pass
(``torch.utils.checkpoint``, as ``nn.remat`` in the JAX package).
The four block projections go through :func:`block_linear`, the seam of
the training variants (LoRA's merge, QAT's fake quantization):
:func:`projection_hooks` installs a hook on every attention and MLP module.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import mha


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


# (name, x, w) -> (x, w): rewrites a block projection's input rows and f32 weight
ProjectionHook = Callable[[str, torch.Tensor, torch.Tensor], tuple]
# (name, x, hook) -> y: computes a block projection from weights held elsewhere (tensor parallelism)
ParallelLinear = Callable[[str, torch.Tensor, Optional[ProjectionHook]], torch.Tensor]


def block_linear(module: nn.Module, name: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One of a block's four projections (``name``: ``in_proj_weight``,
    ``out_proj.weight``, ``c_fc.weight`` or ``c_proj.weight``): ``x @ w.T +
    b`` in ``x``'s dtype, the f32 weight cast per call. The module's
    ``projection_hook``, when set, sees ``(name, x, w)`` before the cast;
    its ``parallel_linear``, when set, computes the projection instead
    (``parallel.tp``: the weight's blocks live elsewhere)."""
    hook = module.projection_hook
    if module.parallel_linear is not None:  # tensor parallelism (parallel.tp) computes it from its blocks
        return module.parallel_linear(name, x, hook)
    if hook is not None:
        x, w = hook(name, x, w)
    dt = x.dtype
    return nn.functional.linear(x, w.to(dt), b.to(dt))


class MultiheadSelfAttention(nn.Module):
    """Fused-qkv self-attention in OpenAI's layout (``in_proj_weight`` [3W, W])."""

    projection_hook: Optional[ProjectionHook] = None
    parallel_linear: Optional[ParallelLinear] = None

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        b, s, w = x.shape
        qkv = block_linear(self, "in_proj_weight", x, self.in_proj_weight, self.in_proj_bias)
        q, k, v = qkv.view(b, s, 3, self.heads, w // self.heads).permute(2, 0, 3, 1, 4)
        out = mha(q, k, v, causal=causal).transpose(1, 2).reshape(b, s, w)
        return block_linear(self, "out_proj.weight", out, self.out_proj.weight, self.out_proj.bias)


class MLP(nn.Module):
    projection_hook: Optional[ProjectionHook] = None
    parallel_linear: Optional[ParallelLinear] = None

    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = quick_gelu(block_linear(self, "c_fc.weight", x, self.c_fc.weight, self.c_fc.bias))
        return block_linear(self, "c_proj.weight", h, self.c_proj.weight, self.c_proj.bias)


@contextlib.contextmanager
def projection_hooks(model: nn.Module, make_hook: Callable[[str], Optional[Callable]],
                     attr: str = "projection_hook"):
    """Set ``make_hook(prefix)`` (a hook or None) as the ``projection_hook``
    (or ``attr``: ``parallel_linear``) of every attention and MLP module of
    ``model`` for the block's duration; ``prefix`` is the module's name
    (``text.transformer.resblocks.0.attn``). A train step holds it over its
    forward and its backward, so a remat recompute sees the same weights."""
    mods = [(n, m) for n, m in model.named_modules() if isinstance(m, (MultiheadSelfAttention, MLP))]
    for n, m in mods:
        setattr(m, attr, make_hook(n))
    try:
        yield
    finally:
        for _, m in mods:
            setattr(m, attr, None)


class ResidualBlock(nn.Module):
    """Pre-LN residual attention block (OpenAI ``ResidualAttentionBlock``).
    Its ``runner(block, x, causal)``, when set, runs the block in its place
    (``body`` is the computation): FSDP builds the block's parameters there
    and recomputes the block in the backward (``parallel.fsdp``), so
    ``remat`` does not wrap it again."""

    runner: Optional[Callable[["ResidualBlock", torch.Tensor, bool], torch.Tensor]] = None

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width)
        self.attn = MultiheadSelfAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width)
        self.mlp = MLP(width)

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        if self.runner is not None:
            return self.runner(self, x, causal)
        return self.body(x, causal)

    def body(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        x = x + self.attn(_ln_f32(self.ln_1, x), causal)
        return x + self.mlp(_ln_f32(self.ln_2, x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(ResidualBlock(width, heads) for _ in range(layers))

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        for blk in self.resblocks:
            if self.remat and torch.is_grad_enabled() and blk.runner is None:
                x = checkpoint(blk, x, causal, use_reentrant=False)
            else:
                x = blk(x, causal)
        return x


class VisionTransformer(nn.Module):
    """CLIP's class-token ViT: images [B, H, W, 3] (NHWC, preprocessed) ->
    [B, embed_dim] f32 (unnormalized)."""

    def __init__(self, arch: CLIPArch, dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        w, p = arch.vision_width, arch.vision_patch_size
        self.conv1 = nn.Conv2d(3, w, kernel_size=p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(w))
        self.positional_embedding = nn.Parameter(torch.empty(arch.grid_size**2 + 1, w))
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = Transformer(w, arch.vision_layers, arch.heads_vision, remat)
        self.ln_post = nn.LayerNorm(w)
        self.proj = nn.Parameter(torch.empty(w, arch.embed_dim))

    def forward(self, images: torch.Tensor, keep_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep_idx`` ([B, P_keep] patch indices) keeps only those patch
        tokens and the class token (FLIP masked training): they are gathered
        after the positions are added, so each kept patch carries its own."""
        dt = self.dtype
        x = nn.functional.conv2d(images.to(dt).permute(0, 3, 1, 2), self.conv1.weight.to(dt),
                                 stride=self.arch.vision_patch_size)
        x = x.flatten(2).transpose(1, 2)  # [B, grid*grid, width], row-major patches
        # each parameter read once, where it is used (FSDP builds it there: parallel.fsdp)
        x = torch.cat([self.class_embedding.to(dt).expand(x.shape[0], 1, -1), x], dim=1)
        x = x + self.positional_embedding.to(dt)
        if keep_idx is not None:
            # the class token (slot 0) always stays; patch i is slot 1 + i
            zero = torch.zeros(x.shape[0], 1, dtype=torch.long, device=x.device)
            slots = torch.cat([zero, keep_idx.long() + 1], dim=1)
            x = torch.gather(x, 1, slots[..., None].expand(-1, -1, x.shape[-1]))
        x = _ln_f32(self.ln_pre, x)
        x = self.transformer(x, causal=False)
        x = _ln_f32(self.ln_post, x[:, 0, :])
        return (x @ self.proj.to(dt)).float()


class TextTransformer(nn.Module):
    """CLIP's causal text tower: ids [B, S] -> [B, embed_dim] f32 (unnormalized)."""

    def __init__(self, arch: CLIPArch, dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        w = arch.text_width
        self.token_embedding = nn.Embedding(arch.vocab_size, w)
        self.positional_embedding = nn.Parameter(torch.empty(arch.context_length, w))
        self.transformer = Transformer(w, arch.text_layers, arch.text_heads, remat)
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


class CLIP(nn.Module):
    """Both towers and ``logit_scale``; embeddings are unnormalized, as in
    the JAX package (callers L2-normalize)."""

    def __init__(self, arch: CLIPArch, dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        self.arch = arch
        self.dtype = dtype
        self.visual = VisionTransformer(arch, dtype, remat)
        self.text = TextTransformer(arch, dtype, remat)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))

    def encode_image(self, images: torch.Tensor, keep_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.visual(images, keep_idx)

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        return self.text(ids)

    def forward(self, images: torch.Tensor, ids: torch.Tensor):
        return self.encode_image(images), self.encode_text(ids), self.logit_scale


def init_weights(model: CLIP, seed: int = 0) -> CLIP:
    """Seeded random weights in place (the flax init's scales: lecun-normal
    projections and patch conv, zero biases, unit LayerNorms, 0.01 text
    positions, width^-0.5 class token, vision positions and projections).
    Drawn on the CPU with a ``torch.Generator``, text tower first, so a seed
    gives the same weights on every device."""
    g = torch.Generator().manual_seed(seed)

    def normal(p: torch.Tensor, std: float) -> None:
        p.data.copy_(torch.randn(p.shape, generator=g) * std)

    def unit(ln: nn.LayerNorm) -> None:
        ln.weight.fill_(1.0)
        ln.bias.zero_()

    def blocks(transformer: Transformer, w: int) -> None:
        for blk in transformer.resblocks:
            normal(blk.attn.in_proj_weight, w**-0.5)
            normal(blk.attn.out_proj.weight, w**-0.5)
            normal(blk.mlp.c_fc.weight, w**-0.5)
            normal(blk.mlp.c_proj.weight, (4 * w) ** -0.5)
            for p in (blk.attn.in_proj_bias, blk.attn.out_proj.bias, blk.mlp.c_fc.bias, blk.mlp.c_proj.bias):
                p.zero_()
            unit(blk.ln_1)
            unit(blk.ln_2)

    a = model.arch
    text, vis = model.text, model.visual
    with torch.no_grad():
        w = a.text_width
        normal(text.token_embedding.weight, w**-0.5)
        normal(text.positional_embedding, 0.01)
        normal(text.text_projection, w**-0.5)
        blocks(text.transformer, w)
        unit(text.ln_final)
        w = a.vision_width
        normal(vis.conv1.weight, (3 * a.vision_patch_size**2) ** -0.5)
        normal(vis.class_embedding, w**-0.5)
        normal(vis.positional_embedding, w**-0.5)
        normal(vis.proj, w**-0.5)
        blocks(vis.transformer, w)
        unit(vis.ln_pre)
        unit(vis.ln_post)
        model.logit_scale.fill_(math.log(1.0 / 0.07))
    return model


def build_model(
    name: str, dtype: torch.dtype = torch.bfloat16, seed: int = 0, device=None,
    arch: Optional[CLIPArch] = None, remat: bool = False,
) -> CLIP:
    """A CLIP for ``ARCHS[name]`` (or ``arch``) with seeded weights;
    ``remat`` recomputes each residual block in the backward pass."""
    if arch is None:
        if name not in ARCHS:
            raise ValueError(f"unknown CLIP variant {name!r}; available: {sorted(ARCHS)}")
        arch = ARCHS[name]
    model = init_weights(CLIP(arch, dtype, remat), seed)
    return model.to(device) if device is not None else model
