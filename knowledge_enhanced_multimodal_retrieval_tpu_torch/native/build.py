"""Lazy g++ build + ctypes loading for native components."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_LOCK = threading.Lock()
_CACHE: dict = {}

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
# the port's one build directory (the CUDA kernels land there too)
_BUILD_DIR = os.path.join(os.path.dirname(_SRC_DIR), "_build")


def _build_dir() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    return _BUILD_DIR


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """Compile ``native/<name>.cpp`` to a shared object (once) and dlopen it.

    Returns None when no compiler is available or the build fails — callers
    fall back to pure Python.
    """
    with _LOCK:
        if name in _CACHE:
            return _CACHE[name]
        src = os.path.join(_SRC_DIR, f"{name}.cpp")
        so = os.path.join(_build_dir(), f"lib{name}.so")
        try:
            if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, src],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, so)  # atomic: processes building at once each land a whole file
            lib = ctypes.CDLL(so)
        except Exception:
            lib = None
        _CACHE[name] = lib
        return lib


def native_available(name: str) -> bool:
    return load_library(name) is not None
