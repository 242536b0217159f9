"""The comparison that decides ``correct`` fails what it should, at a toy
size on the CPU: whole runs of the harness (its look for a card skipped)
with the timed path broken underneath, once for each fault a cell can
have, and the controls (the reference one precision down in the
program's place) against the reference."""

import numpy as np
import pytest
import torch

from port_bench import control, gen, harness
from port_bench.checks import search_text as search_check
from port_bench.runners.common import vocabulary
from port_bench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("bench"), tiny.tiny_bench())


def correct(root, workload, seed=2 ** 31 + 5):
    result = harness.execute(["--workload", workload, "--seed", str(seed), "--seconds", "0.5", "--trace", "0"],
                                root=root, require_chip=False)
    return result["correct"], result["compared"]


def test_sound_runs_are_correct(root):
    assert correct(root, "tiny.search")[0]
    assert correct(root, "tiny.train")[0]


def test_search_answer_altered(root, monkeypatch):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval

    real = CLIPRetrieval.results_from_topk

    def altered(self, vals, idx, _state=None, top_k=None):
        idx = np.array(idx)
        idx[0, 0] = (idx[0, 0] + 1) % 3000  # one answer names another row
        return real(self, vals, idx, _state=_state, top_k=top_k)

    monkeypatch.setattr(CLIPRetrieval, "results_from_topk", altered)
    ok, compared = correct(root, "tiny.search")
    assert not ok and compared["score_gap"]["value"] > compared["score_gap"]["limit"]


def test_search_token_altered(root, monkeypatch):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval import clip_retrieval

    real = clip_retrieval.trim_to_bucket

    def altered(ids, *a, **k):
        ids = np.array(real(ids, *a, **k))
        ids[0, 1] = (ids[0, 1] + 1) % 49406
        return ids

    monkeypatch.setattr(clip_retrieval, "trim_to_bucket", altered)
    ok, compared = correct(root, "tiny.search")
    assert not ok and compared["token_mismatch"]["value"] > 0


def test_search_control_int4_fails(root):
    run = harness.Run(harness.Spec(root), "tiny.search", 9, 0.0, False, torch.device("cpu"))
    (name, compared), = control.search_readings(run, 4)
    assert name == "int4"
    assert any(v > lim for _, v, lim in compared)
    _, maker, _ = vocabulary(run.traffic)
    items = search_check.control_items(run, [q for _, q in gen.query_batches(maker, 9, run.traffic, 4)], bits=8)
    assert all(v <= lim for _, v, lim in search_check.judge(run, items))  # the reference in its own place passes


def test_train_state_unchanged(root, monkeypatch):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.Optimizer, "step", lambda self, grads: None)
    ok, compared = correct(root, "tiny.train")
    assert not ok and compared["update_gap"]["value"] == pytest.approx(1.0)


def test_train_half_the_batch(root, monkeypatch):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer

    real = trainer.make_train_step

    def halved(model, cfg, *a, **k):
        step = real(model, cfg, *a, **k)
        return lambda state, batch: step(state, {n: v[: v.shape[0] // 2] for n, v in batch.items()})

    monkeypatch.setattr(trainer, "make_train_step", halved)
    ok, compared = correct(root, "tiny.train")
    assert not ok and compared["loss_gap"]["value"] > compared["loss_gap"]["limit"]


def test_train_token_altered(root, monkeypatch):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import DataPipeline

    real = DataPipeline.make_batch

    def altered(self, indices):
        b = real(self, indices)
        b.query_ids[:, 1] = (b.query_ids[:, 1] + 1) % 49406
        return b

    monkeypatch.setattr(DataPipeline, "make_batch", altered)
    assert not correct(root, "tiny.train")[0]


def test_train_controls_fail(root):
    run = harness.Run(harness.Spec(root), "tiny.train", 5, 0.0, False, torch.device("cpu"))
    readings = dict(control.train_readings(run))
    assert set(readings) == {"fp8", "half", "token"}
    for name, compared in readings.items():
        assert any(v > lim for _, v, lim in compared), name
