"""Shared CLI plumbing: device, model and data construction from a Config.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/cli/common.py``.
Dataset URIs: ``synthetic:N`` (an offline random corpus) or a HuggingFace
dataset name with the reference schema. ``--device`` defaults to ``cuda``
and never falls back: running on the CPU (the kernels' plain versions)
takes ``--device=cpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ..utils.config import Config

from ..data.datasets import DataPipeline, load_hf_source, make_synthetic_source
from ..data.tokenizer import CLIPTokenizer
from ..models import clip as clip_mod
from ..models.convert import arch_from_state_dict, load_clip_state_dict, load_openai_state_dict, openai_state_dict
from ..ops.dispatch import has_cuda
from ..parallel.mesh import MeshRuntime, default_devices

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def pop_flag(args, flag: str, default=None):
    """Remove ``--flag value`` or ``--flag=value`` from ``args``; return value."""
    prefix = flag + "="
    for i, tok in enumerate(args):
        if tok == flag:
            if i + 1 >= len(args):
                raise ValueError(f"{flag} requires a value")
            val = args[i + 1]
            del args[i : i + 2]
            return val
        if tok.startswith(prefix):
            del args[i]
            return tok[len(prefix):]
    return default


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not has_cuda():
        raise RuntimeError(
            f"--device={name} but PyTorch sees no CUDA device; "
            "pass --device=cpu to run with the kernels' plain versions"
        )
    return device


def merge_adapters(adapters_path: str, sd: Mapping[str, np.ndarray]) -> dict:
    """A LoRA adapter file (``train.lora.save_adapters``, of either package)
    merged into an OpenAI-layout state dict on the host, in f32: the one
    load-time merge every entry point (serve, evaluate, precompute, export)
    shares."""
    from ..train.lora import adapter_scale, load_adapters, lora_merge_host

    adapters, meta = load_adapters(adapters_path)
    return lora_merge_host(sd, {k: v.numpy() for k, v in adapters.items()}, adapter_scale(meta))


def checkpoint_arch(cfg: Config, sd: Mapping[str, np.ndarray]) -> clip_mod.CLIPArch:
    """A checkpoint's arch from its shapes, with the head counts of
    ``model.name``'s arch where that arch has the checkpoint's widths: heads
    are not in the weights, and the JAX package builds the named arch."""
    arch = arch_from_state_dict(sd)
    named = clip_mod.ARCHS.get(cfg.model.name)
    if named is not None and (named.text_width, named.vision_width) == (arch.text_width, arch.vision_width):
        arch = dataclasses.replace(arch, text_heads=named.text_heads, vision_heads=named.heads_vision)
    return arch


def build_model(cfg: Config, device, seed: int = 0) -> clip_mod.CLIP:
    """CLIP from ``model.checkpoint`` (an OpenAI ``.pt``, an HF ``CLIPModel``
    state dict, a flax ``.npz`` tree or an ``.npz`` of OpenAI keys:
    ``models.convert.load_clip_state_dict``) or, without one, weights seeded
    by ``seed``, with ``model.adapters`` (LoRA) merged on the host;
    ``model.remat`` passes on."""
    dtype = _DTYPES[cfg.model.dtype]
    if cfg.model.checkpoint:
        sd = load_clip_state_dict(cfg.model.checkpoint)
        arch = checkpoint_arch(cfg, sd)
    elif not cfg.model.adapters:
        return clip_mod.build_model(cfg.model.name, dtype=dtype, seed=seed, device=device, remat=cfg.model.remat)
    else:
        seeded = clip_mod.build_model(cfg.model.name, dtype=dtype, seed=seed)
        sd, arch = openai_state_dict(seeded), seeded.arch
        del seeded
    if cfg.model.adapters:
        sd = merge_adapters(cfg.model.adapters, sd)
    return load_openai_state_dict(sd, device=device, dtype=dtype, arch=arch, remat=cfg.model.remat)


def build_runtime(cfg: Config, device=None) -> MeshRuntime:
    """The mesh of ``--mesh.*`` (``parallel.mesh.default_devices``): over
    the visible cards, or over ``cpu`` repeated when ``device`` is the CPU
    (``--mesh.data_parallel=4 --device=cpu`` runs four shards). Every
    serving, evaluation, precompute and training CLI builds one."""
    kind = None if device is None else torch.device(device).type
    return MeshRuntime.create(cfg.mesh, default_devices(cfg.mesh, kind))


def build_pipeline(cfg: Config, split: str, tokenizer: Optional[CLIPTokenizer] = None) -> DataPipeline:
    name = cfg.data.dataset
    if name.startswith("synthetic:"):
        source = make_synthetic_source(int(name.split(":", 1)[1]), image_size=cfg.data.image_size)
        tokenizer = tokenizer or CLIPTokenizer([])  # byte fallback: enough for synthetic text
    else:
        source = load_hf_source(name, split)
        tokenizer = tokenizer or CLIPTokenizer.find_default()
    return DataPipeline(
        source,
        tokenizer,
        image_size=cfg.data.image_size,
        context_length=cfg.data.context_length,
        max_text_words=cfg.data.max_text_words,
        num_workers=cfg.data.num_workers,
        preprocess_mode=cfg.data.preprocess_mode,
    )
