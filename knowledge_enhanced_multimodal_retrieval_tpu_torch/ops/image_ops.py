"""Device-side image preprocessing (resize / center-crop / normalize).

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/ops/image_ops.py``:
bicubic shorter-side resize, center crop, scale to [0, 1], per-channel
normalization, on the image tensor's device. Layout is HWC (NHWC batches),
as in the JAX module; ``data.preprocess`` keeps the host PIL path.

The resize is ``jax.image.resize(..., antialias=True)`` written out: per
resized axis a weight matrix ``[in, out]`` from the Keys cubic kernel
(a = -0.5), widened by ``in / out`` on downscale, each output's weights
renormalized to sum to 1 (which also handles the borders), outputs whose
sample point lies outside the input zeroed; applied as one product per
axis, in f32. An axis whose size does not change is left as it is.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# Public OpenAI CLIP normalization constants.
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)

_EPS32 = float(np.finfo(np.float32).eps)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel (a = -0.5) at ``|x|``."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x, min=0.0)


_KERNELS = {"cubic": _keys_cubic, "linear": _triangle}


def resize_weights(in_size: int, out_size: int, method: str = "cubic", antialias: bool = True,
                   device=None) -> torch.Tensor:
    """The ``[in_size, out_size]`` f32 resampling matrix of one axis
    (``jax.image.scale_and_translate`` with no translation)."""
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}; expected one of {sorted(_KERNELS)}")
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = torch.abs(sample[None, :] - torch.arange(in_size, dtype=torch.float32, device=device)[:, None]) / kernel_scale
    w = _KERNELS[method](x)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * _EPS32, w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(image: torch.Tensor, out_hw: Sequence[int], method: str = "cubic", antialias: bool = True) -> torch.Tensor:
    """``[H, W, C]`` -> ``[out_h, out_w, C]`` f32."""
    img = image.float()
    h, w = img.shape[0], img.shape[1]
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if out_h != h:
        img = torch.einsum("hwc,ho->owc", img, resize_weights(h, out_h, method, antialias, img.device))
    if out_w != w:
        img = torch.einsum("hwc,wo->hoc", img, resize_weights(w, out_w, method, antialias, img.device))
    return img


def resize_shorter_side(image: torch.Tensor, size: int, method: str = "cubic") -> torch.Tensor:
    """Resize an ``[H, W, C]`` image so its shorter side equals ``size``,
    keeping the aspect ratio (the long side floored: torchvision's and HF's
    formula); anti-aliased."""
    h, w = image.shape[0], image.shape[1]
    if h <= w:
        new_h, new_w = size, int(w * size / h)
    else:
        new_h, new_w = int(h * size / w), size
    return resize(image, (new_h, new_w), method, antialias=True)


def center_crop(image: torch.Tensor, size: int) -> torch.Tensor:
    """The central ``size`` x ``size`` region of an ``[H, W, C]`` image."""
    h, w = image.shape[0], image.shape[1]
    top = max(0, (h - size) // 2)
    left = max(0, (w - size) // 2)
    return image[top : top + min(size, h), left : left + min(size, w)]


def normalize(image01: torch.Tensor, mean=CLIP_MEAN, std=CLIP_STD) -> torch.Tensor:
    """Per-channel normalize an image already scaled to [0, 1]."""
    mean = torch.as_tensor(mean, dtype=image01.dtype, device=image01.device)
    std = torch.as_tensor(std, dtype=image01.dtype, device=image01.device)
    return (image01 - mean) / std


def preprocess_image(image: torch.Tensor, size: int = 224, method: str = "cubic") -> torch.Tensor:
    """Full CLIP preprocess of one ``[H, W, 3]`` uint8 / float image ->
    ``[size, size, 3]`` f32: resize (shorter side, bicubic) -> center crop
    -> /255 -> normalize."""
    img = resize_shorter_side(image, size, method)
    img = center_crop(img, size)
    img = torch.clamp(img / 255.0, 0.0, 1.0)
    return normalize(img)


def preprocess_batch(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Preprocess a fixed-geometry ``[N, H, W, 3]`` batch."""
    return torch.stack([preprocess_image(im, size=size) for im in images])
