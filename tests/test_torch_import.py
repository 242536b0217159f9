"""The port imports without JAX or Triton, and its kernel loader fails clearly.

Importing must happen in a fresh interpreter: this suite's conftest has
already imported JAX into the test process.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch

REPO = Path(__file__).resolve().parent.parent
PKG = "knowledge_enhanced_multimodal_retrieval_tpu_torch"
SLICE_MODULES = [
    PKG,
    f"{PKG}.ops.dispatch",
    f"{PKG}.ops.fused_block",
    f"{PKG}.ops.similarity",
    f"{PKG}.models.clip",
    f"{PKG}.models.convert",
    f"{PKG}.models.fast_encode",
    f"{PKG}.data.tokenizer",
    f"{PKG}.retrieval.embedding_store",
    f"{PKG}.retrieval.clip_retrieval",
    f"{PKG}.retrieval.engine",
    f"{PKG}.cli.serve",
]


def test_port_imports_without_jax_or_triton():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'triton'))\n"
        "print('LEAKED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_loader_without_nvcc_raises_clearly(tmp_path, monkeypatch):
    monkeypatch.setattr(dispatch, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(dispatch, "NVCC_FALLBACK", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(dispatch, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(dispatch.KernelBuildError, match="nvcc not found"):
        dispatch.library()
    assert not (tmp_path / "_build").exists() or not any((tmp_path / "_build").glob("*.so"))


def test_route_follows_the_tensor_device():
    assert dispatch.use_kernel(torch.zeros(1)) is False
    with pytest.raises(ValueError, match="no kernel or plain route"):
        dispatch.use_kernel(torch.zeros(1, device="meta"))


def test_build_key_covers_sources_and_flags(monkeypatch):
    key = dispatch.source_hash()
    assert dispatch.library_path().name == f"libkemr_kernels_{key}.so"
    assert {p.name for p in dispatch.kernel_sources()} >= {"fused_block.cu", "similarity.cu", "common.cuh"}
    monkeypatch.setattr(dispatch, "NVCC_FLAGS", dispatch.NVCC_FLAGS + ["-lineinfo"])
    assert dispatch.source_hash() != key
