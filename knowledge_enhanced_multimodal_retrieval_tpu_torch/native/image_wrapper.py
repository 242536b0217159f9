"""ctypes wrapper for the native image preprocess engine (image.cpp).

Drop-in accelerator for ``data.preprocess.preprocess_pil``'s compute half
(resize + crop + normalize); decode and RGB conversion stay with PIL. The
call releases the GIL, so ``DataPipeline``'s worker threads preprocess on
real cores in parallel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .build import load_library

_FUNCS = None


def _lib():
    global _FUNCS
    if _FUNCS is not None:
        return _FUNCS
    lib = load_library("image")
    if lib is None:
        _FUNCS = False
        return False
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.kemr_resize_bicubic_u8.restype = None
    lib.kemr_resize_bicubic_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int,
    ]
    lib.kemr_clip_preprocess.restype = ctypes.c_int
    lib.kemr_clip_preprocess.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, f32p,
    ]
    _FUNCS = lib
    return lib


def native_image_available() -> bool:
    return bool(_lib())


def resize_bicubic_u8(arr: np.ndarray, nh: int, nw: int) -> Optional[np.ndarray]:
    """PIL-exact bicubic resize of an RGB uint8 [h, w, 3] array."""
    lib = _lib()
    if not lib:
        return None
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    assert c == 3, "RGB input required"
    out = np.empty((nh, nw, 3), np.uint8)
    lib.kemr_resize_bicubic_u8(arr, h, w, out, nh, nw)
    return out


def clip_preprocess_native(
    arr: np.ndarray, size: int, mode: str, mean, std
) -> Optional[np.ndarray]:
    """Full fused preprocess; returns None when the native engine is absent.

    ``arr`` must be RGB uint8 [h, w, 3] (callers decode/convert first).
    """
    lib = _lib()
    if not lib:
        return None
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w, c = arr.shape
    if c != 3:
        return None
    out = np.empty((size, size, 3), np.float32)
    rc = lib.kemr_clip_preprocess(
        arr, h, w, size, 1 if mode == "hf" else 0,
        np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32),
        out,
    )
    if rc != 0:
        return None
    return out
