"""The port as an installed package, and its runbooks.

``pyproject.toml`` finds packages with ``setuptools.find_packages``, which
skips a directory without ``__init__.py``: every directory of the port that
holds a ``.py`` file must be a package (the git-ignored build directory
aside), or a wheel leaves it out. The port's runbooks
(``knowledge_enhanced_multimodal_retrieval_tpu_torch/scripts/``) call the
port's CLIs; its parity runbook's dry run writes the report the JAX
runbook's does (``tests/test_parity_runbook.py``).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import setuptools

REPO = Path(__file__).resolve().parent.parent
PKG = "knowledge_enhanced_multimodal_retrieval_tpu_torch"
RUNBOOKS = ["real_parity.sh", "serving/precompute_and_serve.sh", "fine-tuning/train.sh", "fine-tuning/eval.sh",
            "fusion/eval.sh", "baselines/run_clip_base_b32.sh", "baselines/run_clip_base_l14.sh"]


def test_find_packages_lists_every_port_directory_with_python():
    found = set(setuptools.find_packages(str(REPO), include=["knowledge_enhanced_multimodal_retrieval_tpu*"]))
    want = set()
    for root, dirs, files in os.walk(REPO / PKG):
        dirs[:] = [d for d in dirs if d not in ("_build", "__pycache__")]
        if any(f.endswith(".py") for f in files):
            want.add(".".join(Path(root).relative_to(REPO).parts))
    assert f"{PKG}.utils" in want and want <= found, sorted(want - found)


def test_pyproject_ships_the_runbooks():
    import tomllib

    data = tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"]["package-data"][PKG]
    for book in RUNBOOKS:
        path = REPO / PKG / "scripts" / book
        assert os.access(path, os.X_OK), book
        assert any(Path("scripts", book).match(glob) for glob in data), (book, data)


@pytest.mark.parametrize("book", RUNBOOKS)
def test_runbooks_call_the_port(book):
    text = (REPO / PKG / "scripts" / book).read_text()
    assert f"python -m {PKG}.cli." in text
    assert "knowledge_enhanced_multimodal_retrieval_tpu.cli" not in text and "compile_cache" not in text


def test_parity_runbook_dry_run_writes_report(tmp_path):
    out = tmp_path / "PARITY_RESULTS.json"
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep + os.environ.get("PATH", ""))
    for var in ("CLIP_BPE_PATH", "CLIP_PT_PATH", "CLIP_HF_PATH"):
        env.pop(var, None)
    run = subprocess.run(["bash", str(REPO / PKG / "scripts" / "real_parity.sh"), "--dry-run", "--device=cpu",
                          "--out", str(out)], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    report = json.loads(out.read_text())
    assert report["ok"] and report["dry_run"] is True
    assert report["stages"] == {"tokenizer": "skipped", "converter_openai": "ok", "converter_hf": "skipped",
                                "evaluation": "ok"}
    assert report["results"]["converter_openai"]["finite"] is True
    ev = report["results"]["evaluation"]
    assert ev["status"] == "ok" and ev["num_samples"] == 32
    assert any(k.startswith("T2I_R@") for k in ev["per_task"])
    assert not (REPO / "PARITY_RESULTS.json").exists()  # the caller's --out, not the default
