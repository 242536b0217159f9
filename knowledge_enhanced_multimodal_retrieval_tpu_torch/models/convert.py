"""Checkpoint I/O: the three on-disk CLIP layouts <-> the port's CLIP.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/models/convert.py``.
The port's towers keep OpenAI's ``clip`` parameter names and layouts
(``in_proj_weight`` [3W, W], Linear weights [out, in], ``visual.conv1``
[W, 3, P, P]), so every layout converts to and from an OpenAI-layout state
dict of numpy arrays, and loading is a split by the ``visual.`` prefix plus
``load_state_dict``. The layouts:

- OpenAI ``clip`` checkpoints (TorchScript archives or raw state dicts) and
  the reference's fine-tuned checkpoints in any of its wrapped layouts
  (raw / ``state_dict`` / ``model_state_dict`` / ``model``, with optional
  DDP ``module.`` prefixes);
- HuggingFace ``CLIPModel`` state dicts (the reference's published model):
  q / k / v projections split, ``pre_layrnorm``, ``[out, in]`` projections;
- the JAX package's flax parameter tree flattened into an ``.npz``
  (``visual/conv1/kernel`` ...: HWIO conv, ``[in, out]`` Dense kernels,
  LayerNorm ``scale``).

:func:`load_clip_state_dict` reads any of them (an ``.npz`` of OpenAI keys
too) into the OpenAI layout; the writers produce each of them from the
port's :class:`CLIP`. The serving plans are then packed from the towers by
``models.fast_encode.make_encode_plans``. Heads are ``width // 64`` (the
OpenAI convention) in both packages: explicit head counts do not survive a
checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .clip import CLIP, CLIPArch

_VISION_PREFIX = "visual."
# scalar entries of OpenAI's TorchScript archives that are not parameters
_OPENAI_METADATA = {"input_resolution", "context_length", "vocab_size"}

StateDict = Dict[str, np.ndarray]


def _f32(x: Any) -> np.ndarray:
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Loading torch files
# ---------------------------------------------------------------------------


def load_torch_state_dict(path: str) -> StateDict:
    """A torch checkpoint file as {name: float32 numpy array}.

    Handles TorchScript archives (OpenAI's ``clip`` distribution), plain
    state dicts and the reference's wrapped layouts, and strips DDP
    ``module.`` prefixes. ``torch.load`` comes first; a file it refuses is
    read with ``torch.jit.load``."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    except Exception:
        obj = torch.jit.load(path, map_location="cpu").state_dict()
    return normalize_state_dict(obj)


def normalize_state_dict(obj: Any) -> StateDict:
    """Unwrap checkpoint layouts and convert tensors to float32 numpy."""
    if hasattr(obj, "state_dict") and not isinstance(obj, Mapping):
        obj = obj.state_dict()
    if isinstance(obj, Mapping):
        for key in ("model_state_dict", "state_dict", "model"):
            if key in obj and isinstance(obj[key], Mapping):
                obj = obj[key]
                break
    out: StateDict = {}
    for k, v in obj.items():
        if not hasattr(v, "shape"):
            continue  # scalars / metadata entries
        name = k[len("module."):] if k.startswith("module.") else k
        out[name] = v.detach().cpu().float().numpy() if hasattr(v, "detach") else _f32(v)
    return out


def detect_format(sd: Mapping[str, np.ndarray]) -> str:
    """'openai' | 'hf' from key fingerprints."""
    if any(k.startswith("visual.conv1") for k in sd):
        return "openai"
    if any(k.startswith("vision_model.") for k in sd):
        return "hf"
    raise ValueError("unrecognized CLIP state dict format")


# ---------------------------------------------------------------------------
# HF CLIPModel layout <-> OpenAI layout
# ---------------------------------------------------------------------------

# (HF name, OpenAI name) of the whole-model tensors kept as they are;
# ``pre_layrnorm`` is transformers' own spelling
_HF_TOP = (
    ("vision_model.embeddings.patch_embedding.weight", "visual.conv1.weight"),
    ("vision_model.embeddings.class_embedding", "visual.class_embedding"),
    ("vision_model.embeddings.position_embedding.weight", "visual.positional_embedding"),
    ("vision_model.pre_layrnorm.weight", "visual.ln_pre.weight"),
    ("vision_model.pre_layrnorm.bias", "visual.ln_pre.bias"),
    ("vision_model.post_layernorm.weight", "visual.ln_post.weight"),
    ("vision_model.post_layernorm.bias", "visual.ln_post.bias"),
    ("text_model.embeddings.token_embedding.weight", "token_embedding.weight"),
    ("text_model.embeddings.position_embedding.weight", "positional_embedding"),
    ("text_model.final_layer_norm.weight", "ln_final.weight"),
    ("text_model.final_layer_norm.bias", "ln_final.bias"),
)
# (HF, OpenAI) projections, each stored transposed in the other layout
_HF_PROJ = (("visual_projection.weight", "visual.proj"), ("text_projection.weight", "text_projection"))
# (HF block name, OpenAI block name) of the per-layer tensors kept as they are
_HF_BLOCK = (
    ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"), ("self_attn.out_proj", "attn.out_proj"),
    ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj"),
)
# (HF tower prefix, OpenAI tower prefix)
_TOWERS = (("vision_model.encoder.layers", "visual.transformer.resblocks"),
           ("text_model.encoder.layers", "transformer.resblocks"))


def _n_layers(sd: Mapping[str, Any], prefix: str) -> int:
    depth = prefix.count(".") + 1
    return 1 + max(int(k.split(".")[depth]) for k in sd if k.startswith(prefix + "."))


def hf_to_openai(sd: Mapping[str, np.ndarray]) -> StateDict:
    """HF ``CLIPModel`` state dict -> OpenAI layout: q / k / v ``[W, W]``
    stacked into ``in_proj_weight`` ``[3W, W]`` (q, k, v order), the
    projections transposed, ``position_ids`` buffers dropped."""
    out: StateDict = {oa: _f32(sd[hf]) for hf, oa in _HF_TOP}
    for hf, oa in _HF_PROJ:
        out[oa] = np.ascontiguousarray(_f32(sd[hf]).T)
    out["logit_scale"] = _f32(sd["logit_scale"]).reshape(())
    for hf_tower, oa_tower in _TOWERS:
        for i in range(_n_layers(sd, hf_tower)):
            hp, op = f"{hf_tower}.{i}", f"{oa_tower}.{i}"
            for hf, oa in _HF_BLOCK:
                for leaf in ("weight", "bias"):
                    out[f"{op}.{oa}.{leaf}"] = _f32(sd[f"{hp}.{hf}.{leaf}"])
            for leaf in ("weight", "bias"):
                out[f"{op}.attn.in_proj_{leaf}"] = np.concatenate(
                    [_f32(sd[f"{hp}.self_attn.{p}_proj.{leaf}"]) for p in "qkv"], axis=0)
    return out


def openai_to_hf(sd: Mapping[str, np.ndarray]) -> StateDict:
    """Inverse of :func:`hf_to_openai`: HF ``CLIPModel`` state-dict keys."""
    out: StateDict = {hf: _f32(sd[oa]) for hf, oa in _HF_TOP}
    for hf, oa in _HF_PROJ:
        out[hf] = np.ascontiguousarray(_f32(sd[oa]).T)
    out["logit_scale"] = _f32(sd["logit_scale"]).reshape(())
    for hf_tower, oa_tower in _TOWERS:
        for i in range(_n_layers(sd, oa_tower)):
            hp, op = f"{hf_tower}.{i}", f"{oa_tower}.{i}"
            for hf, oa in _HF_BLOCK:
                for leaf in ("weight", "bias"):
                    out[f"{hp}.{hf}.{leaf}"] = _f32(sd[f"{op}.{oa}.{leaf}"])
            for leaf in ("weight", "bias"):
                qkv = _f32(sd[f"{op}.attn.in_proj_{leaf}"])
                for p, part in zip("qkv", np.split(qkv, 3, axis=0)):
                    out[f"{hp}.self_attn.{p}_proj.{leaf}"] = np.ascontiguousarray(part)
    return out


# ---------------------------------------------------------------------------
# Flax parameter tree <-> OpenAI layout
# ---------------------------------------------------------------------------


def flatten_params(params: Mapping, prefix: str = "") -> StateDict:
    out: StateDict = {}
    for k, v in params.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_params(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_params(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _block_to_openai(block: Mapping, prefix: str, out: StateDict) -> None:
    for name in ("ln_1", "ln_2"):
        out[f"{prefix}.{name}.weight"] = _f32(block[name]["ln"]["scale"])
        out[f"{prefix}.{name}.bias"] = _f32(block[name]["ln"]["bias"])
    attn, mlp = block["attn"], block["mlp"]
    out[f"{prefix}.attn.in_proj_weight"] = _f32(attn["in_proj"]["kernel"]).T
    out[f"{prefix}.attn.in_proj_bias"] = _f32(attn["in_proj"]["bias"])
    out[f"{prefix}.attn.out_proj.weight"] = _f32(attn["out_proj"]["kernel"]).T
    out[f"{prefix}.attn.out_proj.bias"] = _f32(attn["out_proj"]["bias"])
    for name in ("c_fc", "c_proj"):
        out[f"{prefix}.mlp.{name}.weight"] = _f32(mlp[name]["kernel"]).T
        out[f"{prefix}.mlp.{name}.bias"] = _f32(mlp[name]["bias"])


def _n_blocks(transformer: Mapping) -> int:
    return 1 + max(int(k.split("_")[-1]) for k in transformer if k.startswith("resblocks_"))


_FLAX_TRANSPOSED = ("attn.in_proj_weight", "attn.out_proj.weight", "mlp.c_fc.weight", "mlp.c_proj.weight")


def flax_dims(name: str, ndim: int) -> Tuple[int, ...]:
    """The layout map of one CLIP parameter (port module name or OpenAI
    key): dimension ``i`` of the port's tensor is dimension ``perm[i]`` of
    the JAX package's flax leaf (the transposes of :func:`flax_to_openai`)."""
    if name.endswith(_FLAX_TRANSPOSED):
        return (1, 0)
    if name.endswith("conv1.weight"):
        return (3, 2, 0, 1)
    return tuple(range(ndim))


def flax_to_openai(params: Mapping) -> StateDict:
    """The JAX package's flax tree -> OpenAI layout (conv kernel HWIO ->
    ``[W, 3, P, P]``, Dense ``[in, out]`` -> ``[out, in]``, ``ln.scale`` ->
    ``weight``)."""
    visual, text = params["visual"], params["text"]
    out: StateDict = {
        "visual.conv1.weight": _f32(visual["conv1"]["kernel"]).transpose(3, 2, 0, 1),
        "visual.class_embedding": _f32(visual["class_embedding"]),
        "visual.positional_embedding": _f32(visual["positional_embedding"]),
        "visual.ln_pre.weight": _f32(visual["ln_pre"]["ln"]["scale"]),
        "visual.ln_pre.bias": _f32(visual["ln_pre"]["ln"]["bias"]),
        "visual.ln_post.weight": _f32(visual["ln_post"]["ln"]["scale"]),
        "visual.ln_post.bias": _f32(visual["ln_post"]["ln"]["bias"]),
        "visual.proj": _f32(visual["proj"]),
        "token_embedding.weight": _f32(text["token_embedding"]["embedding"]),
        "positional_embedding": _f32(text["positional_embedding"]),
        "ln_final.weight": _f32(text["ln_final"]["ln"]["scale"]),
        "ln_final.bias": _f32(text["ln_final"]["ln"]["bias"]),
        "text_projection": _f32(text["text_projection"]),
        "logit_scale": _f32(params["logit_scale"]).reshape(()),
    }
    for i in range(_n_blocks(visual["transformer"])):
        _block_to_openai(visual["transformer"][f"resblocks_{i}"], f"visual.transformer.resblocks.{i}", out)
    for i in range(_n_blocks(text["transformer"])):
        _block_to_openai(text["transformer"][f"resblocks_{i}"], f"transformer.resblocks.{i}", out)
    return out


def _block_to_flax(sd: Mapping[str, np.ndarray], prefix: str) -> dict:
    t = lambda name: _f32(sd[f"{prefix}.{name}"]).T  # noqa: E731  [out, in] -> [in, out]
    b = lambda name: _f32(sd[f"{prefix}.{name}"])  # noqa: E731
    return {
        "ln_1": {"ln": {"scale": b("ln_1.weight"), "bias": b("ln_1.bias")}},
        "ln_2": {"ln": {"scale": b("ln_2.weight"), "bias": b("ln_2.bias")}},
        "attn": {
            "in_proj": {"kernel": t("attn.in_proj_weight"), "bias": b("attn.in_proj_bias")},
            "out_proj": {"kernel": t("attn.out_proj.weight"), "bias": b("attn.out_proj.bias")},
        },
        "mlp": {
            "c_fc": {"kernel": t("mlp.c_fc.weight"), "bias": b("mlp.c_fc.bias")},
            "c_proj": {"kernel": t("mlp.c_proj.weight"), "bias": b("mlp.c_proj.bias")},
        },
    }


def openai_to_flax(sd: Mapping[str, np.ndarray]) -> dict:
    """Inverse of :func:`flax_to_openai`: the JAX package's flax tree."""
    ln = lambda name: {"ln": {"scale": _f32(sd[f"{name}.weight"]), "bias": _f32(sd[f"{name}.bias"])}}  # noqa: E731
    visual = {
        "conv1": {"kernel": _f32(sd["visual.conv1.weight"]).transpose(2, 3, 1, 0)},
        "class_embedding": _f32(sd["visual.class_embedding"]),
        "positional_embedding": _f32(sd["visual.positional_embedding"]),
        "ln_pre": ln("visual.ln_pre"),
        "ln_post": ln("visual.ln_post"),
        "proj": _f32(sd["visual.proj"]),
        "transformer": {f"resblocks_{i}": _block_to_flax(sd, f"visual.transformer.resblocks.{i}")
                        for i in range(_n_layers(sd, "visual.transformer.resblocks"))},
    }
    text = {
        "token_embedding": {"embedding": _f32(sd["token_embedding.weight"])},
        "positional_embedding": _f32(sd["positional_embedding"]),
        "ln_final": ln("ln_final"),
        "text_projection": _f32(sd["text_projection"]),
        "transformer": {f"resblocks_{i}": _block_to_flax(sd, f"transformer.resblocks.{i}")
                        for i in range(_n_layers(sd, "transformer.resblocks"))},
    }
    return {"visual": visual, "text": text, "logit_scale": _f32(sd["logit_scale"]).reshape(())}


# ---------------------------------------------------------------------------
# Any layout -> the port's CLIP
# ---------------------------------------------------------------------------


def torch_to_openai(sd: Mapping[str, np.ndarray]) -> StateDict:
    """Auto-detecting conversion of a torch state dict to the OpenAI layout."""
    return dict(sd) if detect_format(sd) == "openai" else hf_to_openai(sd)


def load_clip_state_dict(path: str) -> StateDict:
    """Any supported checkpoint file as an OpenAI-layout state dict: an
    OpenAI ``.pt`` (TorchScript or raw, wrapped or not), an HF ``CLIPModel``
    state dict, a flax ``.npz`` tree, or an ``.npz`` of OpenAI keys."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
        if any("/" in k for k in flat):
            return flax_to_openai(unflatten_params(flat))
        return torch_to_openai({k: _f32(v) for k, v in flat.items()})
    return torch_to_openai(load_torch_state_dict(path))


def arch_from_state_dict(sd: Mapping[str, np.ndarray]) -> CLIPArch:
    """The :class:`CLIPArch` of an OpenAI-layout state dict, from its shapes
    (heads = width // 64, the OpenAI convention)."""
    vocab, width = sd["token_embedding.weight"].shape
    conv = sd["visual.conv1.weight"]  # [width, 3, P, P]
    patch, vwidth = conv.shape[2], conv.shape[0]
    grid = int(round((sd["visual.positional_embedding"].shape[0] - 1) ** 0.5))
    return CLIPArch(
        embed_dim=sd["text_projection"].shape[1],
        image_resolution=grid * patch,
        vision_layers=_n_layers(sd, "visual.transformer.resblocks"),
        vision_width=vwidth,
        vision_patch_size=patch,
        context_length=sd["positional_embedding"].shape[0],
        vocab_size=vocab,
        text_width=width,
        text_heads=width // 64,
        text_layers=_n_layers(sd, "transformer.resblocks"),
    )


def load_openai_state_dict(
    sd: Mapping[str, np.ndarray],
    device=None,
    dtype: torch.dtype = torch.bfloat16,
    arch: Optional[CLIPArch] = None,
    remat: bool = False,
) -> CLIP:
    """The port's CLIP from an OpenAI ``clip`` state dict of numpy arrays.
    ``dtype`` is the compute dtype; parameters load as f32; ``remat``
    recomputes each residual block in the backward pass."""
    arch = arch or arch_from_state_dict(sd)
    model = CLIP(arch, dtype, remat)
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


# ---------------------------------------------------------------------------
# The port's CLIP -> each layout (writers)
# ---------------------------------------------------------------------------


def openai_state_dict(model: Union[CLIP, Mapping[str, np.ndarray]]) -> StateDict:
    """The OpenAI-layout state dict (f32 numpy, on the host) of a port
    :class:`CLIP`; a mapping is taken to be one already."""
    if not isinstance(model, CLIP):
        return {k: _f32(v) for k, v in model.items()}
    out = {_VISION_PREFIX + k: v for k, v in model.visual.state_dict().items()}
    out.update(model.text.state_dict())
    out["logit_scale"] = model.logit_scale.reshape(())
    return {k: v.detach().float().cpu().numpy() for k, v in out.items()}


def _tensors(sd: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    # .copy(): transposed views and read-only arrays are refused by from_numpy
    return {k: torch.from_numpy(np.ascontiguousarray(v).copy()) for k, v in sd.items()}


def _save_torch(sd: Mapping[str, np.ndarray], path: str) -> None:
    torch.save(_tensors(sd), path)


def save_openai_pt(model: Union[CLIP, Mapping[str, np.ndarray]], path: str) -> None:
    """An OpenAI-layout ``.pt`` state dict, loadable by the reference's
    ``load_clip_model(checkpoint_path=...)`` and by both packages."""
    _save_torch(openai_state_dict(model), path)


def save_hf_pt(model: Union[CLIP, Mapping[str, np.ndarray]], path: str) -> None:
    """An HF ``CLIPModel``-layout ``.pt`` state dict (no ``transformers``
    needed), loadable by both packages and by ``CLIPModel.load_state_dict``."""
    _save_torch(openai_to_hf(openai_state_dict(model)), path)


def save_params_npz(model: Union[CLIP, Mapping[str, np.ndarray]], path: str) -> None:
    """The JAX package's flax tree, flattened into an ``.npz``
    (``load_params_npz`` there, :func:`load_clip_state_dict` here)."""
    np.savez(path, **flatten_params(openai_to_flax(openai_state_dict(model))))


def hf_clip_config(arch: CLIPArch) -> Any:
    """``transformers.CLIPConfig`` matching a :class:`CLIPArch`.

    ``hidden_act='quick_gelu'`` and ``eos_token_id=2`` (transformers' marker
    for the legacy argmax-EOT pooling path) reproduce OpenAI-CLIP semantics,
    which the port's towers implement."""
    import transformers

    return transformers.CLIPConfig(
        projection_dim=arch.embed_dim,
        text_config={
            "hidden_size": arch.text_width,
            "intermediate_size": arch.text_width * 4,
            "num_hidden_layers": arch.text_layers,
            "num_attention_heads": arch.text_heads,
            "max_position_embeddings": arch.context_length,
            "vocab_size": arch.vocab_size,
            "hidden_act": "quick_gelu",
            "eos_token_id": 2,
        },
        vision_config={
            "hidden_size": arch.vision_width,
            "intermediate_size": arch.vision_width * 4,
            "num_hidden_layers": arch.vision_layers,
            "num_attention_heads": arch.heads_vision,
            "image_size": arch.image_resolution,
            "patch_size": arch.vision_patch_size,
            "hidden_act": "quick_gelu",
        },
    )


def export_hf_checkpoint(model: Union[CLIP, Mapping[str, np.ndarray]], arch: CLIPArch, out_dir: str) -> str:
    """Write an HF ``CLIPModel`` directory; ``from_pretrained(out_dir)``
    works offline. Keys and shapes are checked strictly: the only tolerated
    mismatches are transformers' non-persistent ``position_ids`` buffers."""
    import transformers

    hf = transformers.CLIPModel(hf_clip_config(arch))
    missing, unexpected = hf.load_state_dict(_tensors(openai_to_hf(openai_state_dict(model))), strict=False)
    bad_missing = [k for k in missing if not k.endswith("position_ids")]
    if bad_missing or unexpected:
        raise ValueError(f"HF export key mismatch: missing={bad_missing} unexpected={list(unexpected)}")
    hf.save_pretrained(out_dir)
    return out_dir
