"""Kernel dispatch for the port: build, load and route to the CUDA kernels.

The rule every kernel wrapper follows: a tensor on the CPU runs the plain
PyTorch version beside the kernel; a CUDA tensor launches the hand-written
kernel or raises. Nothing falls back from one to the other.

The kernels (``csrc/*.cu``) are compiled on first use with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``. The build lands in ``<package>/_build/`` under a name keyed by the
hash of the sources and flags, so a fresh checkout builds once and later
processes reuse the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
]

NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"  # where the CUDA toolkit installs it

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


class KernelBuildError(RuntimeError):
    """The CUDA kernel library could not be built or loaded."""


def has_cuda() -> bool:
    return torch.cuda.is_available()


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain route for device {t.device}")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), NVCC_FALLBACK):
        if cand and os.path.exists(cand):
            return cand
    raise KernelBuildError(
        f"nvcc not found (looked on PATH and at {NVCC_FALLBACK}): the CUDA "
        "kernels are built from csrc/ at first use and need the CUDA toolkit"
    )


def kernel_sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in kernel_sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libkemr_kernels_{source_hash()}.so"


def build_library(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp,
           *[str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        if verbose and proc.stderr:
            print(proc.stderr, flush=True)
        os.replace(tmp, out)  # atomic: two processes building at once both land a whole file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            lib.kemr_error_string.argtypes = [I]
            lib.kemr_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def kernel(name: str, argtypes: list):
    """The C entry ``name`` with its argument types set (pointers and the
    stream as ``c_void_p``: a bare Python int would be cut to 32 bits)."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = I
    return fn


def check(status: int, name: str) -> None:
    if status != 0:
        msg = library().kemr_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, device: torch.device, shape=None) -> None:
    """Kernel-operand checks: device, dtype, contiguity and (optional) shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


# -- launch counters ----------------------------------------------------------
# Each kernel wrapper carries a plain integer ``launches`` that it raises by
# one where it launches its kernel, and nowhere else.

_COUNTED: Dict[str, object] = {}


def counted(fn):
    fn.launches = 0
    _COUNTED[fn.__name__] = fn
    return fn


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in _COUNTED.values():
        fn.launches = 0
