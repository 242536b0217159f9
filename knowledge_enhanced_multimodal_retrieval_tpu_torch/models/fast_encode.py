"""Serving text encoder: packed weight plans + the fused layer kernels.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/models/fast_encode.py``
(text side):

- :func:`make_text_plan` packs the tower's weights once into the serving
  dtype (bf16), in the ``[in, out]`` layout the kernels read; with
  ``quantize="int8"`` the four projections of every layer become
  per-output-channel int8 + f32 scales (W8A8 dynamic).
- :func:`encode_text_fast` runs embeddings, the layers (B3a + B3b per layer
  for a bf16 plan, B1 per layer for an int8 plan), EOT pooling, the final
  LayerNorm and the projection.

The JAX module's VMEM caps and wide-band routing are TPU artifacts: here a
plan's weight dtype alone picks the layer kernel. Semantics match the text
tower (causal mask, f32 LayerNorm, EOT pooling at ``argmax(ids)``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..ops.fused_block import fused_attention_block, fused_layer_q8, fused_mlp_block, quantize_weight
from .clip import TextTransformer

_SEQ_MULTIPLE = 16  # sequences pad to a multiple of 16 rows (mask_len = s)


def make_text_plan(
    model: TextTransformer, dtype: torch.dtype = torch.bfloat16, quantize: Optional[str] = None
) -> Dict[str, Any]:
    """Pack the text tower's weights for :func:`encode_text_fast` (one-time cast)."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode: {quantize!r}")
    cast = lambda t: t.detach().to(dtype).contiguous()  # noqa: E731
    return {
        "token_embedding": cast(model.token_embedding.weight),
        "positional_embedding": cast(model.positional_embedding),
        "layers": _pack_layers(model, dtype, quantize),
        "lnf_scale": model.ln_final.weight.detach().float().contiguous(),
        "lnf_bias": model.ln_final.bias.detach().float().contiguous(),
        "text_projection": cast(model.text_projection),
    }


def _pack_layers(model: TextTransformer, dtype, quantize: Optional[str]) -> List[Dict[str, torch.Tensor]]:
    layers = []
    f32 = lambda t: t.detach().float().contiguous()  # noqa: E731
    for blk in model.transformer.resblocks:
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
            else:
                lp[name] = w.to(dtype).contiguous()
        layers.append(lp)
    return layers


def plan_is_quantized(plan: Dict[str, Any]) -> bool:
    return plan["layers"][0]["wqkv"].dtype == torch.int8


def _apply_layers(x: torch.Tensor, layers, *, s_pad: int, heads: int, mask_len: int, causal: bool) -> torch.Tensor:
    """The residual layers, routed by the plan's weight dtype only."""
    for lp in layers:
        if lp["wqkv"].dtype == torch.int8:
            x = fused_layer_q8(
                x, lp["ln1_scale"], lp["ln1_bias"], lp["wqkv"], lp["wqkv_s"], lp["bqkv"],
                lp["wo"], lp["wo_s"], lp["bo"], lp["ln2_scale"], lp["ln2_bias"],
                lp["w1"], lp["w1_s"], lp["b1"], lp["w2"], lp["w2_s"], lp["b2"],
                seq_len=s_pad, heads=heads, mask_len=mask_len, causal=causal,
            )
        else:
            x = fused_attention_block(
                x, lp["ln1_scale"], lp["ln1_bias"], lp["wqkv"], lp["bqkv"], lp["wo"], lp["bo"],
                seq_len=s_pad, heads=heads, mask_len=mask_len, causal=causal,
            )
            x = fused_mlp_block(x, lp["ln2_scale"], lp["ln2_bias"], lp["w1"], lp["b1"], lp["w2"], lp["b2"])
    return x


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
    x = emb[ids] + plan["positional_embedding"][:s]

    # pad the sequence axis to a multiple of 16 (the pad keys are masked
    # by mask_len = s, and causal rows < s never see them)
    s_pad = -(-s // _SEQ_MULTIPLE) * _SEQ_MULTIPLE
    if s_pad != s:
        x = torch.nn.functional.pad(x, (0, 0, 0, s_pad - s))
    x = x.reshape(b * s_pad, width).contiguous()
    x = _apply_layers(x, plan["layers"], s_pad=s_pad, heads=arch.text_heads, mask_len=s, causal=True)

    # EOT-pool BEFORE the final LayerNorm (row-local, so identical to the
    # tower's LN-then-gather, on B rows instead of B * s_pad)
    eot = ids.argmax(dim=-1)
    pooled = x.view(b, s_pad, width)[torch.arange(b, device=ids.device), eot]
    pf = pooled.float()
    mu = pf.mean(-1, keepdim=True)
    var = (pf - mu).square().mean(-1, keepdim=True)
    pooled = ((pf - mu) * torch.rsqrt(var + 1e-5)) * plan["lnf_scale"] + plan["lnf_bias"]
    return (pooled.to(dtype) @ plan["text_projection"]).float()
