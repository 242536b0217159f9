"""ctypes wrapper for the native BPE merge engine (bpe.cpp)."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

from .build import load_library


class NativeBPE:
    """Applies BPE merges to one pre-tokenized word; exact parity with
    ``CLIPTokenizer.bpe``. Construct via :meth:`create` (returns None when
    the native library is unavailable)."""

    def __init__(self, lib: ctypes.CDLL, handle: ctypes.c_void_p):
        self._lib = lib
        self._handle = handle
        self._buf = ctypes.create_string_buffer(1 << 14)

    @classmethod
    def create(cls, merges: Sequence[Tuple[str, str]]) -> Optional["NativeBPE"]:
        lib = load_library("bpe")
        if lib is None:
            return None
        lib.kemr_bpe_create.restype = ctypes.c_void_p
        lib.kemr_bpe_create.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.kemr_bpe_destroy.argtypes = [ctypes.c_void_p]
        lib.kemr_bpe_apply.restype = ctypes.c_long
        lib.kemr_bpe_apply.argtypes = [
            ctypes.c_void_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_long,
        ]
        blob = "\n".join(f"{a} {b}" for a, b in merges).encode("utf-8")
        handle = lib.kemr_bpe_create(blob, len(blob))
        if not handle:
            return None
        return cls(lib, ctypes.c_void_p(handle))

    def apply(self, word: str) -> str:
        """Merged word as space-joined tokens (same contract as Python bpe)."""
        data = word.encode("utf-8")
        n = self._lib.kemr_bpe_apply(self._handle, data, self._buf, len(self._buf))
        if n < 0:
            raise RuntimeError(f"native bpe buffer too small for word of {len(data)} bytes")
        return self._buf.raw[:n].decode("utf-8")

    def __del__(self):  # pragma: no cover - interpreter-shutdown ordering
        try:
            self._lib.kemr_bpe_destroy(self._handle)
        except Exception:
            pass
