"""Quantization-aware fine-tuning for the int8 serving path.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/train/qat.py``.
The ``int8`` serving encoder (``models.fast_encode``, kernel B1) runs W8A8:
projection weights as symmetric per-output-channel int8, activations as
symmetric per-row int8. ``TrainConfig.qat`` trains through both roundings
with straight-through estimators (``x + (q - x).detach()``: the value of
``q``, the gradient of ``x``):

- **weights**: the four projections of every transformer block (the set
  the serving plan quantizes; ``conv1``, ``visual.proj``,
  ``text_projection`` and the LayerNorms keep full precision) round per
  output channel, which is dim 1 of the port's ``[out, in]`` weights (axis
  0 of flax's ``[in, out]`` kernels);
- **activations**: each of those projections' input rows round per row.

Both go through ``models.clip.block_linear``'s hook (:func:`qat_projections`),
which a train step holds over its forward and backward. Rounding divides by
the scale (no reciprocal, on the card too) and rounds half to even, as ``jnp.round`` does;
the optimizer keeps f32 master weights and checkpoints stay plain.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from ..models.clip import projection_hooks

# the block projections the int8 serving plan packs (flax: in_proj, out_proj, c_fc, c_proj)
QAT_WEIGHT_NAMES = ("attn.in_proj_weight", "attn.out_proj.weight", "mlp.c_fc.weight", "mlp.c_proj.weight")


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The value of ``q``, the gradient of ``x``."""
    return x + (q - x).detach()


def _fake_quant(x32: torch.Tensor, dim: int) -> torch.Tensor:
    # 127 as a tensor on the device: a CUDA tensor divided by a Python number
    # is multiplied by its reciprocal, which moves some scales by one ulp
    s = (x32.abs().amax(dim=dim, keepdim=True) / x32.new_tensor(127.0)).clamp_min(1e-12)
    return _ste(x32, torch.clamp(torch.round(x32 / s), -127, 127) * s)


def fake_quant_weight(w: torch.Tensor) -> torch.Tensor:
    """An ``[out, in]`` weight through symmetric per-output-channel int8
    (``ops.fused_block.quantize_weight``'s math on its ``[in, out]``
    transpose): ``round(w / s) * s``, ``s = max|w|_row / 127``."""
    return _fake_quant(w.float(), dim=1).to(w.dtype)


def fake_quant_rows(x: torch.Tensor) -> torch.Tensor:
    """Activations through symmetric per-row int8 (B1's input rounding), in f32."""
    return _fake_quant(x.float(), dim=-1).to(x.dtype)


def is_qat_weight(name: str) -> bool:
    return ".transformer.resblocks." in name and name.endswith(QAT_WEIGHT_NAMES)


def qat_params(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The block projection weights of a CLIP parameter dict (module names)
    fake-quantized; every other entry as it is."""
    return {n: fake_quant_weight(p) if is_qat_weight(n) else p for n, p in params.items()}


def qat_hook(name: str, x: torch.Tensor, w: torch.Tensor):
    """The ``block_linear`` hook of a QAT forward: both roundings."""
    return fake_quant_rows(x), fake_quant_weight(w)


def qat_projections(model: torch.nn.Module) -> contextlib.AbstractContextManager:
    """Every block projection of ``model`` fake-quantized while the block runs."""
    return projection_hooks(model, lambda prefix: qat_hook)
