"""Weights carried across: OpenAI-layout state dicts -> the port's text tower.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/models/convert.py``.
The port's modules keep OpenAI's ``clip`` parameter names and layouts
(``in_proj_weight`` [3W, W], Linear weights [out, in]), so conversion is a
key filter plus ``load_state_dict``. The serving plan is then packed from
the tower by ``models.fast_encode.make_text_plan``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .clip import CLIPArch, TextTransformer

_VISION_PREFIX = "visual."


def text_arch_from_state_dict(sd: Mapping[str, np.ndarray]) -> CLIPArch:
    """The :class:`CLIPArch` of an OpenAI-layout state dict, from its shapes
    (heads = width // 64, the OpenAI convention)."""
    vocab, width = sd["token_embedding.weight"].shape
    layers = 1 + max(int(k.split(".")[2]) for k in sd if k.startswith("transformer.resblocks."))
    if "visual.conv1.weight" in sd:
        conv = sd["visual.conv1.weight"]  # [width, 3, P, P]
        patch, vwidth = conv.shape[2], conv.shape[0]
        grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
        vlayers = 1 + max(
            int(k.split(".")[3]) for k in sd if k.startswith("visual.transformer.resblocks.")
        )
        vision = dict(image_resolution=grid * patch, vision_layers=vlayers, vision_width=vwidth,
                      vision_patch_size=patch)
    else:
        vision = dict(image_resolution=0, vision_layers=0, vision_width=0, vision_patch_size=1)
    return CLIPArch(
        embed_dim=sd["text_projection"].shape[1],
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=vocab,
        text_width=width,
        text_heads=width // 64,
        text_layers=layers,
        **vision,
    )


def load_openai_state_dict(
    sd: Mapping[str, np.ndarray],
    device=None,
    dtype: torch.dtype = torch.bfloat16,
    arch: Optional[CLIPArch] = None,
) -> TextTransformer:
    """The port's text tower from an OpenAI ``clip`` state dict of numpy
    arrays (vision entries are ignored until the vision tower is ported).
    ``dtype`` is the tower's compute dtype; parameters load as f32."""
    arch = arch or text_arch_from_state_dict(sd)
    model = TextTransformer(arch, dtype)
    text_sd = {
        k: torch.from_numpy(np.array(v, np.float32))
        for k, v in sd.items()
        if not k.startswith(_VISION_PREFIX) and k != "logit_scale"
    }
    model.load_state_dict(text_sd, strict=True)
    return model.to(device) if device is not None else model


def from_flax_params(
    params: Mapping, device=None, dtype: torch.dtype = torch.bfloat16, arch: Optional[CLIPArch] = None
) -> TextTransformer:
    """The port's text tower from a flax CLIP parameter tree, through the
    JAX package's ``flax_to_openai`` layout. The caller holds flax params,
    so JAX is already loaded; the port imports it nowhere else."""
    from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai

    return load_openai_state_dict(flax_to_openai(params), device=device, dtype=dtype, arch=arch)
