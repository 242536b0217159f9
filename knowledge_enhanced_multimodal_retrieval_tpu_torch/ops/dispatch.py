"""Kernel dispatch for the port: build, load and route to the CUDA kernels.

The rule every kernel wrapper follows: a tensor on the CPU runs the plain
PyTorch version beside the kernel; a CUDA tensor launches the hand-written
kernel or raises. Nothing falls back from one to the other.

The blended top-k kernels (B2 behind ``ops.similarity.fused_similarity_topk``
and its q8 / q4 forms, B5 behind ``ops.pq.pq_similarity_topk``) take every
``k`` on a CUDA tensor: one launch selects up to ``KL`` = 512 rows
(``ops.similarity.KERNEL_PASS_K``; running lists in shared memory up to 128
rows, in the candidate buffer above), and a larger ``k`` runs as passes of
at most 512, each under the ceiling of the pass before
(``ops.similarity.topk_passes``).

The kernels (``csrc/*.cu``) are compiled on first use with ``nvcc`` for
``sm_90a``, one ``nvcc`` per source, all started together, and linked into
one shared library with a plain C interface, loaded with ``ctypes``. The
build lands in ``<package>/_build/`` under a name keyed by the hash of the
sources and flags, so a fresh checkout builds once and later processes
reuse the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..utils.profiling import span

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

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
    """Compile ``csrc/*.cu`` into the shared library unless it exists: one
    ``nvcc -c`` per source, all running at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    with span("kernels.build"):
        _compile_library(out, verbose)
    return out


def _compile_library(out: Path, verbose: bool) -> None:
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        sources = sorted(CSRC_DIR.glob("*.cu"))
        objects = [os.path.join(tmp_dir, src.stem + ".o") for src in sources]
        ptxas = ["-Xptxas", "-v"] if verbose else []
        cmds = [[nvcc, *NVCC_FLAGS, *ptxas, "-c", str(src), "-o", obj] for src, obj in zip(sources, objects)]
        compiles = [
            (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for cmd in cmds
        ]
        failed = []
        for cmd, proc in compiles:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{stdout}\n{stderr}")
            elif verbose and stderr:
                print(stderr, flush=True)
        if failed:
            raise KernelBuildError("\n".join(failed))
        tmp = os.path.join(tmp_dir, "lib.so")
        cmd = [nvcc, *GENCODE, "-shared", "-o", tmp, *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: two processes building at once both land a whole file


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


_KERNELS: Dict[str, object] = {}


def kernel(name: str, argtypes: list):
    """The C entry ``name`` with its argument types set (pointers and the
    stream as ``c_void_p``: a bare Python int would be cut to 32 bits)."""
    fn = _KERNELS.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = I
        _KERNELS[name] = fn
    return fn


def check(status: int, name: str) -> None:
    if status != 0:
        msg = library().kemr_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``, its copy queued without waiting for a card: a host
    tensor bound for one is staged in pinned memory first (the caching host
    allocator keeps the block until the copy has run)."""
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


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
# Each kernel wrapper carries an integer ``launches`` that it raises by one
# (:func:`count_launch`) where it launches its kernel, and nowhere else. The
# daemon launches from several threads at once (the text and image
# micro-batch workers, filtered requests on request threads), so the
# counters change under a lock.

_COUNTED: Dict[str, object] = {}
_COUNT_LOCK = threading.Lock()


def operands_device(args, kwargs) -> Optional[torch.device]:
    """The one CUDA device that every CUDA tensor argument lies on, or None
    when there is none. Operands on two cards raise: a kernel reads its
    operands from the device it launches on, and would otherwise return
    wrong winners without an error."""
    devs = {a.device for a in (*args, *kwargs.values()) if torch.is_tensor(a) and a.is_cuda}
    if len(devs) > 1:
        raise ValueError(f"kernel operands lie on several cards: {sorted(str(d) for d in devs)}")
    return next(iter(devs), None)


def counted(fn):
    """A kernel wrapper with a launch counter, run with its operands' card
    current (:func:`operands_device`): the C entries launch on the current
    device, which on a mesh of several cards need not hold the operands.
    Each call is a span ``kernel.<wrapper>`` of ``utils.profiling``."""
    name = "kernel." + fn.__name__

    @functools.wraps(fn)
    def on_operands_device(*args, **kwargs):
        with span(name):
            dev = operands_device(args, kwargs)
            if dev is None:
                return fn(*args, **kwargs)
            with torch.cuda.device(dev):
                return fn(*args, **kwargs)

    on_operands_device.launches = 0
    _COUNTED[fn.__name__] = on_operands_device
    return on_operands_device


def count_launch(fn) -> None:
    with _COUNT_LOCK:
        fn.launches += 1


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for fn in _COUNTED.values():
            fn.launches = 0
