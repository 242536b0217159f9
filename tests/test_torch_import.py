"""The port imports without JAX, Triton or the JAX package, and its kernel
loader fails clearly.

Importing must happen in a fresh interpreter: this suite's conftest has
already imported JAX into the test process.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch

REPO = Path(__file__).resolve().parent.parent
PKG = "knowledge_enhanced_multimodal_retrieval_tpu_torch"
JAX_PKG = "knowledge_enhanced_multimodal_retrieval_tpu"
SLICE_MODULES = [
    PKG,
    f"{PKG}.ops.dispatch",
    f"{PKG}.ops.attention",
    f"{PKG}.ops.flash_attention",
    f"{PKG}.ops.fused_block",
    f"{PKG}.ops.similarity",
    f"{PKG}.ops.pq",
    f"{PKG}.ops.binary_sketch",
    f"{PKG}.models.clip",
    f"{PKG}.models.convert",
    f"{PKG}.models.fast_encode",
    f"{PKG}.data.tokenizer",
    f"{PKG}.data.preprocess",
    f"{PKG}.data.datasets",
    f"{PKG}.eval",
    f"{PKG}.eval.evaluator",
    f"{PKG}.eval.metrics",
    f"{PKG}.eval.fusion",
    f"{PKG}.eval.quality",
    f"{PKG}.eval.autotune",
    f"{PKG}.models.fusion_heads",
    f"{PKG}.ops.image_ops",
    f"{PKG}.train",
    f"{PKG}.train.fusion_trainer",
    f"{PKG}.cli.evaluate",
    f"{PKG}.cli.train_fusion",
    f"{PKG}.scripts.quality_sweep",
    f"{PKG}.scripts.autotune",
    f"{PKG}.scripts.consistency_check",
    f"{PKG}.retrieval.embedding_store",
    f"{PKG}.retrieval.ann",
    f"{PKG}.retrieval.clip_retrieval",
    f"{PKG}.retrieval.engine",
    f"{PKG}.retrieval.server",
    f"{PKG}.retrieval.http_server",
    f"{PKG}.cli.common",
    f"{PKG}.cli.precompute",
    f"{PKG}.cli.serve",
    f"{PKG}.cli.index",
    f"{PKG}.utils.config",
    f"{PKG}.utils.logging_utils",
    f"{PKG}.utils.profiling",
    f"{PKG}.utils.data_utils",
    f"{PKG}.native",
    f"{PKG}.native.build",
    f"{PKG}.native.bpe_wrapper",
    f"{PKG}.native.image_wrapper",
    f"{PKG}.native.rerank_wrapper",
    f"{PKG}.knowledge",
    f"{PKG}.knowledge.circuit",
    f"{PKG}.knowledge.clients",
    f"{PKG}.knowledge.entity_linking",
    f"{PKG}.knowledge.json2sparql",
    f"{PKG}.knowledge.kg",
    f"{PKG}.knowledge.text2sparql",
    f"{PKG}.scripts.profile_vision_interior",
    f"{PKG}.scripts.time_topk",
    f"{PKG}.scripts.daemon_bench",
    f"{PKG}.scripts.timing",
    f"{PKG}.scripts.profile_serving",
    f"{PKG}.scripts.profile_vision",
    f"{PKG}.scripts.vision_batch_sweep",
    f"{PKG}.scripts.profile_pq",
    f"{PKG}.scripts.profile_ivf",
    f"{PKG}.scripts.scale_bench",
    f"{PKG}.cli.parity",
    f"{PKG}.cli.baseline_text",
    f"{PKG}.baselines",
    f"{PKG}.baselines.text_models",
    f"{PKG}.datagen",
    f"{PKG}.datagen.captioning",
    f"{PKG}.datagen.metadata",
    f"{PKG}.datagen.texts",
    f"{PKG}.train.losses",
    f"{PKG}.train.schedule",
    f"{PKG}.train.checkpoint",
    f"{PKG}.train.trainer",
    f"{PKG}.cli.train",
    f"{PKG}.cli.export",
    f"{PKG}.scripts.train_bench",
    f"{PKG}.scripts.profile_parallel",
    f"{PKG}.train.qat",
    f"{PKG}.train.lora",
    f"{PKG}.train.gradcache",
    f"{PKG}.train.negatives",
    f"{PKG}.train.distill",
    f"{PKG}.cli.mine_negatives",
    f"{PKG}.cli.distill",
    f"{PKG}.scripts.qat_payoff",
    f"{PKG}.parallel",
    f"{PKG}.parallel.mesh",
    f"{PKG}.parallel.sharding",
    f"{PKG}.parallel.replicas",
    f"{PKG}.parallel.fsdp",
    f"{PKG}.parallel.tp",
    f"{PKG}.parallel.pp",
    f"{PKG}.parallel.sp",
    f"{PKG}.parallel.ep",
    f"{PKG}.retrieval.multihost",
    f"{PKG}.scripts.dryrun_multichip",
]


def test_port_imports_without_jax_or_triton():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'triton', {JAX_PKG!r}))\n"
        "print('LEAKED', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_every_port_module_is_in_the_import_list():
    have = {
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / PKG).rglob("*.py") if "_build" not in p.parts
    }
    assert have - set(SLICE_MODULES) <= {f"{PKG}.{sub}" for sub in
                                         ("cli", "data", "eval", "models", "ops", "retrieval", "scripts", "utils")}


_IMPORT_OF_JAX_PKG = re.compile(rf"^\s*(from|import)\s+{JAX_PKG}(\.|\s|$)", re.MULTILINE)


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(REPO)) for p in (REPO / PKG).rglob("*.py") if "_build" not in p.parts) + ["chip_smoke.py"]
)
def test_no_source_imports_the_jax_package(path):
    """No ``import`` / ``from`` line names the JAX package or JAX itself
    (docstrings may name them)."""
    text = (REPO / path).read_text()
    assert not _IMPORT_OF_JAX_PKG.search(text), path
    assert not re.search(r"^\s*(from|import)\s+(jax|jaxlib|flax)(\.|\s|$)", text, re.MULTILINE), path


def test_the_import_pattern_catches_an_import():
    assert _IMPORT_OF_JAX_PKG.search(f"x = 1\n    from {JAX_PKG}.utils.config import Config\n")
    assert _IMPORT_OF_JAX_PKG.search(f"import {JAX_PKG}\n")
    assert not _IMPORT_OF_JAX_PKG.search(f"from {PKG}.utils import config\n# the copy of {JAX_PKG}/utils\n")


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
    assert {p.name for p in dispatch.kernel_sources()} >= {"attention.cu", "fused_block.cu", "similarity.cu", "pq.cu", "common.cuh", "topk.cuh"}
    monkeypatch.setattr(dispatch, "NVCC_FLAGS", dispatch.NVCC_FLAGS + ["-lineinfo"])
    assert dispatch.source_hash() != key


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One ``nvcc -c`` per source, all started before any is waited on,
    then one ``-shared`` link (a stand-in nvcc records its calls)."""
    log = tmp_path / "calls.txt"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then : > "$2"; fi; shift; done\n'
    )
    nvcc.chmod(0o755)
    monkeypatch.setattr(dispatch, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(dispatch, "NVCC_FALLBACK", str(nvcc))
    monkeypatch.setenv("PATH", str(tmp_path))
    out = dispatch.build_library()
    assert out.exists() and out.parent == tmp_path / "_build"
    calls = log.read_text().splitlines()
    sources = sorted(p.name for p in dispatch.CSRC_DIR.glob("*.cu"))
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert sorted(c.split(" -c ")[1].split()[0].rsplit("/", 1)[-1] for c in compiles) == sources
    assert len(calls) == len(sources) + 1 and "-shared" in calls[-1]
    assert not list((tmp_path / "_build").glob("tmp*"))  # the object files went with their temp dir
