"""The port's parity runbook (``cli.parity``) held to the JAX package's.

The dry run of both packages writes a report with the same stage statuses
and the same keys in every stage; without artifacts a real-data run gives
all ``skipped`` in both. With a tiny checkpoint as ``CLIP_PT_PATH`` and an
HF export as ``CLIP_HF_PATH`` both packages run every converter stage to
``ok`` (the HF stage at cosine >= 0.999 against ``CLIPModel``), and the
HF stage reports ``failed`` (not skipped) when ``transformers`` cannot be
imported.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from knowledge_enhanced_multimodal_retrieval_tpu.cli.parity import main as jparity
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models import convert as JC
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.parity import main as tparity
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import convert as TC

_ARTIFACTS = ("CLIP_BPE_PATH", "CLIP_PT_PATH", "CLIP_HF_PATH")


@pytest.fixture
def no_artifacts(monkeypatch):
    for var in _ARTIFACTS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _shape(report):
    """The report's structure: stage statuses and each stage's keys."""
    return report["stages"], {k: sorted(v) for k, v in report["results"].items()}


def test_dry_run_report_equals_jax(tmp_path, devices8, no_artifacts):
    want = jparity(["--dry-run", "--out", str(tmp_path / "jax.json")])
    got = tparity(["--dry-run", "--out", str(tmp_path / "port.json"), "--device=cpu"])
    assert got["ok"] and got["dry_run"] is True
    assert sorted(got) == sorted(want)
    assert _shape(got) == _shape(want)
    assert got["stages"] == {"tokenizer": "skipped", "converter_openai": "ok", "converter_hf": "skipped",
                             "evaluation": "ok"}
    assert json.load(open(tmp_path / "port.json"))["stages"] == got["stages"]
    co, jco = got["results"]["converter_openai"], want["results"]["converter_openai"]
    assert co["finite"] is True and co["cosine"] is None and co["note"] == jco["note"]
    ev, jev = got["results"]["evaluation"], want["results"]["evaluation"]
    assert ev["num_samples"] == jev["num_samples"] == 32
    assert sorted(ev["per_task"]) == sorted(jev["per_task"]) and sorted(ev["weighted"]) == sorted(jev["weighted"])
    assert sorted(got["artifacts"]) == sorted(want["artifacts"])
    assert got["ran"] == want["ran"] == ["converter_openai", "evaluation"]


def test_real_data_without_artifacts_skips_every_stage(tmp_path, devices8, no_artifacts):
    want = jparity(["--out", str(tmp_path / "jax.json"), "--data.dataset="])
    got = tparity(["--out", str(tmp_path / "port.json"), "--data.dataset=", "--device=cpu"])
    assert got["ok"] and want["ok"]
    assert set(got["stages"].values()) == {"skipped"} and got["stages"] == want["stages"]
    assert {k: v["reason"] for k, v in got["results"].items()} == {k: v["reason"] for k, v in want["results"].items()}


def test_the_cli_refuses_a_missing_card(tmp_path, no_artifacts):
    if TM.torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="--device=cpu"):
        tparity(["--dry-run", "--out", str(tmp_path / "r.json")])


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    transformers = pytest.importorskip("transformers")
    root = tmp_path_factory.mktemp("parity_artifacts")
    arch = JM.CLIPArch(32, 32, 1, 64, 16, 16, 600, 64, 1, 1)  # the byte-fallback vocabulary fits
    params = jax.tree_util.tree_map(np.asarray, JM.init_params(JM.CLIP(arch, dtype=jnp.float32),
                                                               jax.random.PRNGKey(1)))
    pt = str(root / "clip.pt")
    JC.save_openai_pt(params, pt)
    tower = TC.load_openai_state_dict(TC.load_clip_state_dict(pt))
    hf_dir = TC.export_hf_checkpoint(tower, TM.CLIPArch(32, 32, 1, 64, 16, 16, 600, 64, 1, 1), str(root / "hf"))
    assert transformers.CLIPModel.from_pretrained(hf_dir, local_files_only=True) is not None
    return pt, hf_dir


def test_converter_stages_with_artifacts_match_jax(tmp_path, devices8, no_artifacts, artifacts):
    pt, hf_dir = artifacts
    no_artifacts.setenv("CLIP_PT_PATH", pt)
    no_artifacts.setenv("CLIP_HF_PATH", hf_dir)
    args = ["--data.dataset=", "--model.dtype=float32"]
    want = jparity(["--out", str(tmp_path / "jax.json")] + args)
    got = tparity(["--out", str(tmp_path / "port.json"), "--device=cpu"] + args)
    assert _shape(got) == _shape(want)
    assert got["stages"] == {"tokenizer": "skipped", "converter_openai": "ok", "converter_hf": "ok",
                             "evaluation": "skipped"}
    cos = got["results"]["converter_hf"]["cosine"]
    assert min(cos.values()) >= 0.999
    for key in ("image", "text"):
        assert cos[key] == pytest.approx(want["results"]["converter_hf"]["cosine"][key], abs=1e-6)


def test_real_mode_evaluates_the_checkpoint(tmp_path, no_artifacts, artifacts):
    pt, _ = artifacts
    no_artifacts.setenv("CLIP_PT_PATH", pt)
    got = tparity(["--out", str(tmp_path / "port.json"), "--device=cpu", "--data.dataset=synthetic:16",
                   "--data.image_size=32", "--data.context_length=16", "--eval.batch_size=8",
                   "--eval.encoder=int8"])
    assert got["stages"]["converter_openai"] == "ok" and got["stages"]["evaluation"] == "ok", got
    assert got["results"]["evaluation"]["num_samples"] == 16
    assert all(np.isfinite(v) for v in got["results"]["evaluation"]["per_task"].values())
    assert os.path.exists(tmp_path / "parity_eval.json")


def test_hf_stage_fails_without_transformers(tmp_path, no_artifacts, artifacts):
    _, hf_dir = artifacts
    no_artifacts.setenv("CLIP_HF_PATH", hf_dir)
    no_artifacts.setitem(sys.modules, "transformers", None)  # import raises ImportError
    got = tparity(["--out", str(tmp_path / "port.json"), "--device=cpu", "--data.dataset="])
    assert got["stages"]["converter_hf"] == "failed" and not got["ok"]
    assert got["results"]["converter_hf"]["error"].startswith(("ImportError", "ModuleNotFoundError"))
