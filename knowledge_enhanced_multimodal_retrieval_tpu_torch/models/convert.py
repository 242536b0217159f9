"""Weights carried across: OpenAI-layout state dicts -> the port's CLIP.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/models/convert.py``.
The port's towers keep OpenAI's ``clip`` parameter names and layouts
(``in_proj_weight`` [3W, W], Linear weights [out, in], ``visual.conv1``
[W, 3, P, P]), so conversion is a split by the ``visual.`` prefix plus
``load_state_dict``. The serving plans are then packed from the towers by
``models.fast_encode.make_encode_plans``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .clip import CLIP, CLIPArch

_VISION_PREFIX = "visual."
# scalar entries of OpenAI's TorchScript archives that are not parameters
_OPENAI_METADATA = {"input_resolution", "context_length", "vocab_size"}


def arch_from_state_dict(sd: Mapping[str, np.ndarray]) -> CLIPArch:
    """The :class:`CLIPArch` of an OpenAI-layout state dict, from its shapes
    (heads = width // 64, the OpenAI convention)."""
    vocab, width = sd["token_embedding.weight"].shape
    layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("transformer.resblocks."))
    conv = sd["visual.conv1.weight"]  # [width, 3, P, P]
    patch, vwidth = conv.shape[2], conv.shape[0]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    vlayers = 1 + max(int(k.split(".")[3]) for k in sd if k.startswith("visual.transformer.resblocks."))
    return CLIPArch(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=grid * patch,
        vision_layers=vlayers,
        vision_width=vwidth,
        vision_patch_size=patch,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=vocab,
        text_width=width,
        text_heads=width // 64,
        text_layers=layers,
    )


def load_openai_state_dict(
    sd: Mapping[str, np.ndarray],
    device=None,
    dtype: torch.dtype = torch.bfloat16,
    arch: Optional[CLIPArch] = None,
) -> CLIP:
    """The port's CLIP from an OpenAI ``clip`` state dict of numpy arrays.
    ``dtype`` is the compute dtype; parameters load as f32."""
    arch = arch or arch_from_state_dict(sd)
    model = CLIP(arch, dtype)
    t = lambda v: torch.from_numpy(np.array(v, np.float32))  # noqa: E731
    vision = {k[len(_VISION_PREFIX):]: t(v) for k, v in sd.items() if k.startswith(_VISION_PREFIX)}
    text = {
        k: t(v) for k, v in sd.items()
        if not k.startswith(_VISION_PREFIX) and k != "logit_scale" and k not in _OPENAI_METADATA
    }
    model.visual.load_state_dict(vision, strict=True)
    model.text.load_state_dict(text, strict=True)
    with torch.no_grad():
        model.logit_scale.copy_(t(sd["logit_scale"]).reshape(()))
    return model.to(device) if device is not None else model
