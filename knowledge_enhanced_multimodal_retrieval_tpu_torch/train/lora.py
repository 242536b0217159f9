"""LoRA: low-rank adaptation for CLIP fine-tuning.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/train/lora.py``.
Rank-``r`` updates ``W + (alpha / r) * (A @ B)ᵀ`` train on the transformer
block projections instead of all ~428 M ViT-L/14 parameters: AdamW's
moments shrink to a few MB and the artifact per domain is the adapter file.

- Adapters keep the flax orientation: ``a`` is ``[in, r]``, ``b`` is
  ``[r, out]``; the merged OpenAI-layout weight is ``W + scale * (a @ b)ᵀ``,
  added in f32 and cast per call to the compute dtype (the JAX
  ``lora_merge``'s rounding order).
- Init as in the LoRA paper: A ~ N(0, 1/r) from a ``torch.Generator`` (on
  the CPU, so a seed gives the same adapters on every device), B = 0: the
  merged model equals the base at step 0.
- Adapters are keyed by the base weight's module name plus ``.a`` / ``.b``
  (``text.transformer.resblocks.0.attn.in_proj_weight.a``), so the trainer's
  freezing rule applies to them by their tower.
- The train step merges inside the forward, through ``models.clip.block_linear``'s
  hook (:func:`lora_projections`), held over the forward and the backward;
  the base stays frozen (``requires_grad=False``). Attention still runs B6.
- The adapter ``.npz`` uses the JAX package's keys (flax paths joined by
  ``/`` plus ``/a`` and ``/b``, and a ``__meta__`` JSON), so a file written
  by either package loads in the other.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..models.clip import projection_hooks

_TARGET_SUFFIXES = {
    "attn": ("attn.in_proj_weight", "attn.out_proj.weight"),
    "mlp": ("mlp.c_fc.weight", "mlp.c_proj.weight"),
}
_TARGET_SUFFIXES["all"] = _TARGET_SUFFIXES["attn"] + _TARGET_SUFFIXES["mlp"]

# module name <-> flax path of a block projection
_FLAX_OF = {"attn.in_proj_weight": "attn/in_proj/kernel", "attn.out_proj.weight": "attn/out_proj/kernel",
            "mlp.c_fc.weight": "mlp/c_fc/kernel", "mlp.c_proj.weight": "mlp/c_proj/kernel"}
_MODULE_OF = {v: k for k, v in _FLAX_OF.items()}
_NAME_RE = re.compile(r"(visual|text)\.transformer\.resblocks\.(\d+)\.(.+)")
_PATH_RE = re.compile(r"(visual|text)/transformer/resblocks_(\d+)/(.+)")

Adapters = Dict[str, torch.Tensor]


def _check(rank: int, targets: str) -> None:
    if targets not in _TARGET_SUFFIXES:
        raise ValueError(f"unknown lora targets {targets!r}: expected one of {sorted(_TARGET_SUFFIXES)}")
    if rank < 1:
        raise ValueError(f"lora rank must be >= 1, got {rank}")


def is_target(name: str, targets: str) -> bool:
    return _NAME_RE.fullmatch(name) is not None and name.endswith(_TARGET_SUFFIXES[targets])


def flax_path(name: str) -> str:
    """``visual.transformer.resblocks.3.attn.in_proj_weight`` ->
    ``visual/transformer/resblocks_3/attn/in_proj/kernel``."""
    tower, i, rest = _NAME_RE.fullmatch(name).groups()
    return f"{tower}/transformer/resblocks_{i}/{_FLAX_OF[rest]}"


def module_name(path: str) -> str:
    """Inverse of :func:`flax_path`."""
    m = _PATH_RE.fullmatch(path)
    if m is None or m.group(3) not in _MODULE_OF:
        raise ValueError(f"{path!r} is not a LoRA target's flax path")
    tower, i, rest = m.groups()
    return f"{tower}.transformer.resblocks.{i}.{_MODULE_OF[rest]}"


def openai_key(name: str) -> str:
    """The OpenAI state-dict key of a module name (the text tower's lose ``text.``)."""
    return name[len("text."):] if name.startswith("text.") else name


def lora_init(params: Mapping[str, torch.Tensor], rank: int, targets: str = "attn",
              generator: Optional[torch.Generator] = None) -> Adapters:
    """``{name.a: [in, r], name.b: [r, out]}`` for every target weight of
    ``params`` (module names, ``[out, in]`` weights), A ~ N(0, 1/r) drawn
    on the CPU in the order of ``params``, B = 0, on each weight's device."""
    _check(rank, targets)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    out: Adapters = {}
    for name, w in params.items():
        if w.ndim != 2 or not is_target(name, targets):
            continue
        d_out, d_in = w.shape
        out[name + ".a"] = (torch.randn(d_in, rank, generator=g) / math.sqrt(rank)).to(w.device)
        out[name + ".b"] = torch.zeros(rank, d_out, device=w.device)
    return out


def adapted_names(adapters: Mapping[str, Any]):
    """The base weights' names, in the adapters' order."""
    return [n[: -len(".a")] for n in adapters if n.endswith(".a")]


def lora_delta(adapters: Mapping[str, torch.Tensor], name: str, scale: float) -> torch.Tensor:
    """``scale * (a @ b)ᵀ``: an ``[out, in]`` update in f32."""
    return scale * (adapters[name + ".a"] @ adapters[name + ".b"]).t()


def lora_merge(params: Mapping[str, torch.Tensor], adapters: Mapping[str, torch.Tensor],
               scale: float) -> Dict[str, torch.Tensor]:
    """``W + scale * (a @ b)ᵀ`` on the adapted weights (in their dtype);
    every other entry passes through."""
    out = dict(params)
    for name in adapted_names(adapters):
        w = params[name]
        out[name] = (w + lora_delta(adapters, name, scale).to(w.dtype)).to(w.dtype)
    return out


def lora_merge_host(sd: Mapping[str, np.ndarray], adapters: Mapping[str, np.ndarray],
                    scale: float) -> Dict[str, np.ndarray]:
    """:func:`lora_merge` in numpy on an OpenAI-layout state dict (the
    load-time merge of ``--model.adapters``): the JAX ``lora_merge_host``'s
    arithmetic, ``(W + scale * (a @ b)ᵀ)`` in the weight's dtype."""
    out = dict(sd)
    for name in adapted_names(adapters):
        key = openai_key(name)
        w = np.asarray(sd[key])
        delta = np.asarray(adapters[name + ".a"]) @ np.asarray(adapters[name + ".b"])
        out[key] = (w + scale * delta.T).astype(w.dtype)
    return out


def lora_param_count(adapters: Mapping[str, Any]) -> int:
    return sum(int(np.prod(v.shape)) for v in adapters.values())


def lora_projections(model: torch.nn.Module, adapters: Mapping[str, torch.Tensor], scale: float,
                     then=None):
    """The block projections of ``model`` merged with ``adapters`` while the
    block runs (``hook(name, x, w)`` adds ``scale * (a @ b)ᵀ`` to ``w``);
    ``then`` (QAT's hook) runs on the merged weight."""
    adapted = set(adapted_names(adapters))

    def make_hook(prefix: str):
        def hook(name, x, w):
            full = f"{prefix}.{name}"
            if full in adapted:
                w = w + lora_delta(adapters, full, scale)
            return then(name, x, w) if then is not None else (x, w)

        if then is None and not any(n.startswith(prefix + ".") for n in adapted):
            return None
        return hook

    return projection_hooks(model, make_hook)


def save_adapters(path: str, adapters: Mapping[str, torch.Tensor], meta: Dict[str, Any]) -> None:
    """The adapters and ``meta`` as one ``.npz`` in the JAX package's keys."""
    flat = {}
    for name in adapted_names(adapters):
        key = flax_path(name)
        for part in ("a", "b"):
            flat[f"{key}/{part}"] = adapters[f"{name}.{part}"].detach().float().cpu().numpy()
    np.savez(path, __meta__=json.dumps(meta), **flat)


def load_adapters(path: str, device=None) -> Tuple[Adapters, Dict[str, Any]]:
    """A :func:`save_adapters` file (of either package): (adapters by module
    names, f32 on ``device``; meta)."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        paths = sorted(k[: -len("/a")] for k in data.files if k.endswith("/a"))
        adapters: Adapters = {}
        for p in paths:
            name = module_name(p)
            for part in ("a", "b"):
                adapters[f"{name}.{part}"] = torch.from_numpy(np.array(data[f"{p}/{part}"], np.float32)).to(device)
    return adapters, meta


def adapter_scale(meta: Mapping[str, Any]) -> float:
    return float(meta["alpha"]) / float(meta["rank"])
