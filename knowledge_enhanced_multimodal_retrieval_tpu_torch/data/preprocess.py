"""Host-side image preprocessing, bit-equal to the JAX package's.

The port's copy of ``knowledge_enhanced_multimodal_retrieval_tpu/data/preprocess.py``
(that module's package imports JAX on the way in). Two parity modes:
``"openai"`` (torchvision ``Resize(BICUBIC) -> CenterCrop`` with
round-half-even crop offsets, as ``clip.load``) and ``"hf"``
(``CLIPImageProcessor``, floor offsets). Both convert to RGB first, resize
the shortest edge with PIL's antialiased bicubic, rescale by 1/255 and
normalize with the CLIP mean/std.

The compute half runs in the port's native engine
(``native/image.cpp``, bit-exact with the PIL path) when it builds. An RGB
``uint8`` array goes to it as it is: ``Image.fromarray(a).convert("RGB")``
returns the same pixels, so such input needs no PIL at all. Decode
failures fall back to a zero image (:func:`safe_preprocess`).
"""

from __future__ import annotations

import io
from typing import Tuple

import numpy as np

from ..native.image_wrapper import clip_preprocess_native

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _to_pil(image):
    from PIL import Image

    if isinstance(image, Image.Image):
        return image
    if isinstance(image, (bytes, bytearray)):
        return Image.open(io.BytesIO(image))
    if isinstance(image, np.ndarray):
        return Image.fromarray(image)
    if isinstance(image, str):
        return Image.open(image)
    raise TypeError(f"unsupported image input type {type(image)!r}")


def _rgb_array(image) -> np.ndarray:
    """Decoded RGB ``uint8 [h, w, 3]`` pixels of ``image``."""
    if isinstance(image, np.ndarray) and image.dtype == np.uint8 and image.ndim == 3 and image.shape[2] == 3:
        return np.ascontiguousarray(image)
    return np.asarray(_to_pil(image).convert("RGB"))


def resize_shortest_edge(img, size: int):
    """Shortest-edge bicubic resize, identical in torchvision and HF."""
    from PIL import Image

    w, h = img.size
    if w <= h:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    return img.resize((new_w, new_h), resample=Image.BICUBIC)


def preprocess_pil(image, size: int = 224, mode: str = "openai", use_native=None) -> np.ndarray:
    """CLIP preprocess: returns ``[size, size, 3]`` float32 (normalized).

    ``image`` is a PIL image, encoded bytes, a file path or an HWC ``uint8``
    array. ``use_native=None`` uses the native engine when it builds,
    ``True`` requires it, ``False`` takes the PIL path."""
    if mode not in ("openai", "hf"):
        raise ValueError(f"unknown preprocess mode {mode!r}; use 'openai' or 'hf'")
    arr = _rgb_array(image)
    if use_native or use_native is None:
        out = clip_preprocess_native(arr, size, mode, CLIP_MEAN, CLIP_STD)
        if out is not None:
            return out
        if use_native:
            raise RuntimeError("native image engine requested but unavailable")
    from PIL import Image

    img = resize_shortest_edge(Image.fromarray(arr), size)
    new_w, new_h = img.size
    if mode == "openai":  # torchvision CenterCrop: round-half-even offsets
        left = int(round((new_w - size) / 2.0))
        top = int(round((new_h - size) / 2.0))
    else:  # HF image_transforms.center_crop: floor offsets
        left = (new_w - size) // 2
        top = (new_h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    out = np.asarray(img, dtype=np.float32) / 255.0
    return (out - np.asarray(CLIP_MEAN, np.float32)) / np.asarray(CLIP_STD, np.float32)


def safe_preprocess(image, size: int = 224, mode: str = "openai") -> Tuple[np.ndarray, bool]:
    """Preprocess with a zero-image fallback on decode error: ``(array, ok)``
    (reference ``clip_dataset.py:66-71``)."""
    try:
        return preprocess_pil(image, size, mode=mode), True
    except Exception:
        return np.zeros((size, size, 3), dtype=np.float32), False
