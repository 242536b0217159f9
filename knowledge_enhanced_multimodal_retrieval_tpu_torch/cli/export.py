"""Export trained weights to the torch ecosystem's layouts.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/export.py``:

    # from a training checkpoint of the port (train.checkpoint)
    python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.export \
        --model.name=ViT-L/14 --train-dir checkpoints --role best \
        --format hf|openai|npz --out exported/clip

    # re-layout any checkpoint models.convert.load_clip_state_dict reads
    python -m ...cli.export --model.checkpoint=weights.npz --format openai --out weights.pt

``hf`` writes a ``CLIPModel`` directory (needs ``transformers``), ``openai``
an OpenAI-layout ``.pt`` state dict, ``npz`` the JAX package's flattened
flax tree. A checkpoint of an EMA run exports the EMA shadow;
``--model.adapters`` (a LoRA adapter file) is merged before the re-layout,
so the adapted model is what is written. The conversion runs on the host.
"""

from __future__ import annotations

import logging
import os
import sys

from ..models import clip as clip_mod
from ..models.convert import (
    arch_from_state_dict,
    export_hf_checkpoint,
    load_clip_state_dict,
    save_openai_pt,
    save_params_npz,
)
from ..train.checkpoint import load_params_only
from ..utils.config import config_from_argv
from .common import merge_adapters, pop_flag

FORMATS = ("hf", "openai", "npz")
logger = logging.getLogger("kemr_torch.cli.export")


def module_to_openai(params) -> dict:
    """The OpenAI-layout state dict (f32 numpy) of parameters named as the
    port's CLIP module names them: the text tower's lose their ``text.``."""
    return {k[len("text."):] if k.startswith("text.") else k: v.float().numpy() for k, v in params.items()}


def main(argv=None) -> str:
    args = list(sys.argv[1:] if argv is None else argv)
    out = pop_flag(args, "--out")
    fmt = pop_flag(args, "--format", "hf")
    train_dir = pop_flag(args, "--train-dir")
    role = pop_flag(args, "--role", "best")
    if fmt not in FORMATS:
        raise ValueError(f"--format must be one of {FORMATS}, got {fmt!r}")
    if not out:
        raise ValueError("--out is required")
    cfg = config_from_argv(args)

    if train_dir:
        sd = module_to_openai(load_params_only(train_dir, role))
    elif cfg.model.checkpoint:
        sd = load_clip_state_dict(cfg.model.checkpoint)
    else:
        raise ValueError("provide --train-dir or --model.checkpoint")
    if cfg.model.adapters:
        sd = merge_adapters(cfg.model.adapters, sd)
        logger.info("merged LoRA adapters from %s", cfg.model.adapters)

    if fmt == "hf":
        # named variants pin the head counts; otherwise the OpenAI width // 64
        arch = clip_mod.ARCHS.get(cfg.model.name) or arch_from_state_dict(sd)
        export_hf_checkpoint(sd, arch, out)
    else:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        (save_openai_pt if fmt == "openai" else save_params_npz)(sd, out)
    logger.info("exported %s-format checkpoint to %s", fmt, out)
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
