"""Serving encoders: packed weight plans + the fused layer kernels.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/models/fast_encode.py``:

- :func:`make_text_plan` / :func:`make_vision_plan` pack a tower's weights
  once into the serving dtype (bf16), in the ``[in, out]`` layout the
  kernels read; with ``quantize="int8"`` the four projections of every
  layer become per-output-channel int8 + f32 scales (W8A8 dynamic), each
  kept twice: ``[in, out]`` (the contract of the kernels' wrappers and of
  their plain versions) and its K-major ``[out, in]`` copy under ``*_t``,
  which the int8 kernels' GEMM reads (one more byte per weight; the
  tensor cores' 8-bit operands cannot be read transposed).
  :func:`make_encode_plans` packs both, keyed ``visual`` / ``text``.
- :func:`encode_text_fast` / :func:`encode_image_fast` run the embeddings,
  the layers (B3a + B3b per layer for a bf16 plan; for an int8 plan B1 per
  layer, or B4a then B4b for a layer over ``_LAYER_Q8_WIDE_CAP``), the
  pooling, the final LayerNorm and the projection.

The JAX module's other VMEM caps, and its branches that give an oversized
block to the XLA reference, are TPU artifacts and are not carried over: a
plan's weight dtype and that one size rule pick the layer kernels.
Semantics match the towers (causal text / bidirectional vision attention,
f32 LayerNorm, EOT / class-token pooling).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..ops.fused_block import (
    _ln_f32,
    fused_attention_block,
    fused_attention_block_q8,
    fused_layer_q8,
    fused_mlp_block,
    fused_mlp_block_q8,
    k_major,
    quantize_weight,
)
from .clip import CLIP, Transformer

_SEQ_MULTIPLE = 16  # sequences pad to a multiple of 16 rows (mask_len = s)


def _check_quantize(quantize: Optional[str]) -> None:
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode: {quantize!r}")


def make_text_plan(
    model: CLIP, dtype: torch.dtype = torch.bfloat16, quantize: Optional[str] = None
) -> Dict[str, Any]:
    """Pack the text tower's weights for :func:`encode_text_fast` (one-time cast)."""
    _check_quantize(quantize)
    text = model.text
    cast = lambda t: t.detach().to(dtype).contiguous()  # noqa: E731
    return {
        "token_embedding": cast(text.token_embedding.weight),
        "positional_embedding": cast(text.positional_embedding),
        "layers": _pack_layers(text.transformer, dtype, quantize),
        "lnf_scale": text.ln_final.weight.detach().float().contiguous(),
        "lnf_bias": text.ln_final.bias.detach().float().contiguous(),
        "text_projection": cast(text.text_projection),
    }


def make_vision_plan(
    model: CLIP, dtype: torch.dtype = torch.bfloat16, quantize: Optional[str] = None
) -> Dict[str, Any]:
    """Pack the vision tower's weights for :func:`encode_image_fast`. The
    patch conv (stride == kernel size) becomes an exact patch-matmul weight
    ``[P*P*3, W]`` whose rows run (row, column, channel) within a patch, the
    order in which :func:`encode_image_fast` cuts NHWC patches."""
    _check_quantize(quantize)
    vis = model.visual
    cast = lambda t: t.detach().to(dtype).contiguous()  # noqa: E731
    f32 = lambda t: t.detach().float().contiguous()  # noqa: E731
    conv = vis.conv1.weight.detach()  # [W, 3, P, P]
    return {
        "conv_w": cast(conv.permute(2, 3, 1, 0).reshape(-1, conv.shape[0])),
        "class_embedding": cast(vis.class_embedding),
        "positional_embedding": cast(vis.positional_embedding),
        "ln_pre_scale": f32(vis.ln_pre.weight), "ln_pre_bias": f32(vis.ln_pre.bias),
        "layers": _pack_layers(vis.transformer, dtype, quantize),
        "ln_post_scale": f32(vis.ln_post.weight), "ln_post_bias": f32(vis.ln_post.bias),
        "proj": cast(vis.proj),
    }


def make_encode_plans(
    model: CLIP, dtype: torch.dtype = torch.bfloat16, quantize: Optional[str] = None
) -> Dict[str, Any]:
    """Both towers' packed plans, keyed like the JAX package's (visual/text)."""
    return {
        "visual": make_vision_plan(model, dtype=dtype, quantize=quantize),
        "text": make_text_plan(model, dtype=dtype, quantize=quantize),
    }


def _pack_layers(transformer: Transformer, dtype, quantize: Optional[str]) -> List[Dict[str, torch.Tensor]]:
    layers = []
    f32 = lambda t: t.detach().float().contiguous()  # noqa: E731
    for blk in transformer.resblocks:
        lp = {
            "ln1_scale": f32(blk.ln_1.weight), "ln1_bias": f32(blk.ln_1.bias),
            "bqkv": f32(blk.attn.in_proj_bias), "bo": f32(blk.attn.out_proj.bias),
            "ln2_scale": f32(blk.ln_2.weight), "ln2_bias": f32(blk.ln_2.bias),
            "b1": f32(blk.mlp.c_fc.bias), "b2": f32(blk.mlp.c_proj.bias),
        }
        # torch Linear weights are [out, in]; the kernels read [in, out]
        weights = {
            "wqkv": blk.attn.in_proj_weight.detach().t(), "wo": blk.attn.out_proj.weight.detach().t(),
            "w1": blk.mlp.c_fc.weight.detach().t(), "w2": blk.mlp.c_proj.weight.detach().t(),
        }
        for name, w in weights.items():
            if quantize == "int8":
                wq, ws = quantize_weight(w)
                lp[name], lp[name + "_s"] = wq.contiguous(), ws.contiguous()
                lp[name + "_t"] = k_major(lp[name])
            else:
                lp[name] = w.to(dtype).contiguous()
        layers.append(lp)
    return layers


def plan_is_quantized(plan: Dict[str, Any]) -> bool:
    return plan["layers"][0]["wqkv"].dtype == torch.int8


# The reference's routing rule (its ``models/fast_encode.py``), kept by name
# and value so both packages split the same layers; it was sized for the
# TPU's VMEM and is no Hopper limit. An int8 layer whose four projections
# hold at most this many bytes runs the whole-layer kernel B1, a larger one
# runs the per-block pair B4a then B4b (the same arithmetic, bit for bit).
# No arch in ``models.clip.ARCHS`` crosses it (ViT-L/14 vision: 12 MiB).
_LAYER_Q8_WIDE_CAP = 24 * 2**20


def _layer_weight_bytes(lp: Dict[str, torch.Tensor]) -> int:
    return sum(lp[k].numel() * lp[k].element_size() for k in ("wqkv", "wo", "w1", "w2"))


def _apply_layers(x: torch.Tensor, layers, *, s_pad: int, heads: int, mask_len: int, causal: bool) -> torch.Tensor:
    """The residual layers, routed by the plan's weight dtype and, for an
    int8 layer, by its weight bytes against ``_LAYER_Q8_WIDE_CAP``."""
    for lp in layers:
        if lp["wqkv"].dtype == torch.int8 and _layer_weight_bytes(lp) > _LAYER_Q8_WIDE_CAP:
            x = fused_attention_block_q8(
                x, lp["ln1_scale"], lp["ln1_bias"], lp["wqkv"], lp["wqkv_s"], lp["bqkv"],
                lp["wo"], lp["wo_s"], lp["bo"], seq_len=s_pad, heads=heads, mask_len=mask_len, causal=causal,
                wqkv_qt=lp.get("wqkv_t"), wo_qt=lp.get("wo_t"),
            )
            x = fused_mlp_block_q8(
                x, lp["ln2_scale"], lp["ln2_bias"], lp["w1"], lp["w1_s"], lp["b1"], lp["w2"], lp["w2_s"], lp["b2"],
                w1_qt=lp.get("w1_t"), w2_qt=lp.get("w2_t"),
            )
        elif lp["wqkv"].dtype == torch.int8:
            x = fused_layer_q8(
                x, lp["ln1_scale"], lp["ln1_bias"], lp["wqkv"], lp["wqkv_s"], lp["bqkv"],
                lp["wo"], lp["wo_s"], lp["bo"], lp["ln2_scale"], lp["ln2_bias"],
                lp["w1"], lp["w1_s"], lp["b1"], lp["w2"], lp["w2_s"], lp["b2"],
                seq_len=s_pad, heads=heads, mask_len=mask_len, causal=causal,
                wqkv_qt=lp.get("wqkv_t"), wo_qt=lp.get("wo_t"), w1_qt=lp.get("w1_t"), w2_qt=lp.get("w2_t"),
            )
        else:
            x = fused_attention_block(
                x, lp["ln1_scale"], lp["ln1_bias"], lp["wqkv"], lp["bqkv"], lp["wo"], lp["bo"],
                seq_len=s_pad, heads=heads, mask_len=mask_len, causal=causal,
            )
            x = fused_mlp_block(x, lp["ln2_scale"], lp["ln2_bias"], lp["w1"], lp["b1"], lp["w2"], lp["b2"])
    return x


def _pad_sequences(x: torch.Tensor) -> torch.Tensor:
    """[B, s, W] -> [B * s_pad, W] with s_pad the next multiple of 16 (the
    pad keys are masked by mask_len = s)."""
    b, s, width = x.shape
    s_pad = -(-s // _SEQ_MULTIPLE) * _SEQ_MULTIPLE
    if s_pad != s:
        x = torch.nn.functional.pad(x, (0, 0, 0, s_pad - s))
    return x.reshape(b * s_pad, width).contiguous()


def encode_text_fast(arch, plan: Dict[str, Any], ids: torch.Tensor) -> torch.Tensor:
    """ids [B, S] integer -> [B, embed_dim] float32 (unnormalized embeddings).

    ``ids`` must lie on the plan's device; the kernels run there (a CPU plan
    runs their plain versions)."""
    b, s = ids.shape
    emb = plan["token_embedding"]
    width = emb.shape[1]
    dtype = emb.dtype
    if ids.device != emb.device:
        raise ValueError(f"ids on {ids.device}, plan on {emb.device}")
    x = _pad_sequences(emb[ids] + plan["positional_embedding"][:s])  # causal rows < s never see the pad
    s_pad = x.shape[0] // b
    x = _apply_layers(x, plan["layers"], s_pad=s_pad, heads=arch.text_heads, mask_len=s, causal=True)

    # EOT-pool BEFORE the final LayerNorm (row-local, so identical to the
    # tower's LN-then-gather, on B rows instead of B * s_pad)
    eot = ids.argmax(dim=-1)
    pooled = x.view(b, s_pad, width)[torch.arange(b, device=ids.device), eot]
    pooled = _ln_f32(pooled, plan["lnf_scale"], plan["lnf_bias"], 1e-5)
    return (pooled.to(dtype) @ plan["text_projection"]).float()


def encode_image_fast(arch, plan: Dict[str, Any], images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] (NHWC, preprocessed) -> [B, embed_dim] float32.

    The strided conv is an exact patch matmul, the class token and positions
    are added in the plan dtype, ``ln_pre`` runs in f32, the sequence pads
    to a multiple of 16 (257 -> 272 at ViT-L/14) with the pad keys masked,
    the layers attend both ways, and the class token is pooled before the
    f32 ``ln_post`` and the projection. ``images`` must lie on the plan's
    device."""
    conv_w = plan["conv_w"]
    width, dtype = conv_w.shape[1], conv_w.dtype
    b, p, g = images.shape[0], arch.vision_patch_size, arch.grid_size
    if tuple(images.shape[1:]) != (g * p, g * p, 3):
        raise ValueError(f"images must be [B, {g * p}, {g * p}, 3], got {tuple(images.shape)}")
    if images.device != conv_w.device:
        raise ValueError(f"images on {images.device}, plan on {conv_w.device}")

    # strided conv == patch matmul: [B, g, p, g, p, 3] -> [B, g*g, p*p*3]
    x = images.to(dtype).reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
    x = x @ conv_w
    cls = plan["class_embedding"].expand(b, 1, width)
    x = torch.cat([cls, x], dim=1) + plan["positional_embedding"]
    s = g * g + 1
    x = _pad_sequences(_ln_f32(x, plan["ln_pre_scale"], plan["ln_pre_bias"], 1e-5).to(dtype))
    s_pad = x.shape[0] // b
    x = _apply_layers(x, plan["layers"], s_pad=s_pad, heads=arch.heads_vision, mask_len=s, causal=False)

    # class-token pool, then the f32 LN on the B pooled rows (row-local)
    pooled = _ln_f32(x.view(b, s_pad, width)[:, 0], plan["ln_post_scale"], plan["ln_post_bias"], 1e-5)
    return (pooled.to(dtype) @ plan["proj"]).float()
