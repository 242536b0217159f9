"""ctypes wrapper for the native candidate-rescore kernel (rerank.cpp).

``rerank_scores_native`` computes the [Q, R] blended exact scores of the
fetched candidate rows in one GIL-free pass (no [Q, R, D] gather
temporaries); returns None when the native library is unavailable so
callers fall back to NumPy (ops/similarity.py::rerank_scores_host).
Opt-in via ``KEMR_NATIVE_RERANK=1``: single-threaded it is ~1.3x slower
than the BLAS per-query loop (the rescore is DRAM-gather-bound), but the
released GIL lets concurrent server threads overlap rescoring with device
dispatch on multi-core hosts.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from .build import load_library

_SIG_READY = False


def _lib():
    global _SIG_READY
    lib = load_library("rerank")
    if lib is not None and not _SIG_READY:
        lib.rerank_scores.restype = None
        lib.rerank_scores.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        _SIG_READY = True
    return lib


def rerank_scores_native(queries, image, text, idx, alpha) -> Optional[np.ndarray]:
    """[Q, R] blended scores, or None if the native engine is unavailable.

    ``alpha`` scalar or length-Q. Invalid rows (idx < 0 / >= N) come back
    -inf. Inputs are staged to C-contiguous f32/i32 (no-op when already so
    — the EmbeddingStore's arrays are; mmap-backed stores gather through
    the page cache like the NumPy path would).
    """
    lib = _lib()
    if lib is None:
        return None
    queries = np.ascontiguousarray(queries, np.float32)
    image = np.ascontiguousarray(image, np.float32)
    text = np.ascontiguousarray(text, np.float32)
    idx = np.ascontiguousarray(idx, np.int32)
    qn, d = queries.shape
    r = idx.shape[1]
    a = np.broadcast_to(np.asarray(alpha, np.float32).reshape(-1), (qn,))
    a = np.ascontiguousarray(a)
    out = np.empty((qn, r), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    lib.rerank_scores(
        queries.ctypes.data_as(fp), image.ctypes.data_as(fp),
        text.ctypes.data_as(fp), idx.ctypes.data_as(ip),
        a.ctypes.data_as(fp), out.ctypes.data_as(fp),
        qn, r, d, image.shape[0],
    )
    return out
