"""The port's evaluation path held to the JAX package's.

Metrics and fusion run on embeddings the JAX package encodes (seeded numpy
inputs where no model is needed): equal ranks and metric values to rel 1e-6;
the stripe ranking equals the dense one; the fusion sweep agrees cell by
cell; ``run_full_evaluation`` and ``cli.evaluate`` run on one
``flax_to_openai`` checkpoint of a small arch beside the JAX CLI.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.cli import evaluate as j_cli
from knowledge_enhanced_multimodal_retrieval_tpu.data.datasets import DataPipeline as JPipe
from knowledge_enhanced_multimodal_retrieval_tpu.data.datasets import make_synthetic_source as j_source
from knowledge_enhanced_multimodal_retrieval_tpu.data.tokenizer import CLIPTokenizer as JTok
from knowledge_enhanced_multimodal_retrieval_tpu.eval import evaluator as JE
from knowledge_enhanced_multimodal_retrieval_tpu.eval import fusion as JF
from knowledge_enhanced_multimodal_retrieval_tpu.eval import metrics as JMET
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import MeshRuntime
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import evaluate as t_cli
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import DataPipeline as TPipe
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import make_synthetic_source as t_source
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import evaluator as TE
from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import fusion as TF
from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import metrics as TMET
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_openai_state_dict

# embed 32; vision width 128 (2 heads, the OpenAI width // 64 rule the port's
# checkpoint reader applies); text width 128, 2 heads, context 16
ARCH = JM.CLIPArch(32, 32, 1, 128, 16, 16, 600, 128, 2, 1)
N, BATCH = 24, 8


def _norm(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def embeds():
    """Correlated query / image / target rows (ranks 1 ... N occur)."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal((40, 16))
    return tuple(_norm(base + s * rng.standard_normal((40, 16))) for s in (0.6, 0.7, 0.8))


def _hits(n, every=3):
    """Every ``every``-th query has itself and one other row as hits, plus a
    URI outside the corpus; some queries have none."""
    return {f"u{i}": [f"http://kg/artefact/u{i}", f"u{(i * 7) % n}", "http://kg/other"]
            for i in range(0, n, every)}


def _same_metrics(got, want, rel=1e-6):
    assert set(got) == set(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=rel, abs=1e-9), key


def test_metrics_match_jax_on_the_same_embeddings(embeds):
    q, t, i = embeds
    sim = q @ i.T
    np.testing.assert_array_equal(TMET.diagonal_ranks(sim).numpy(), np.asarray(JMET.diagonal_ranks(sim)))
    _same_metrics(TMET.compute_all_retrieval_metrics(q, t, i), JMET.compute_all_retrieval_metrics(q, t, i))
    _same_metrics(TMET.compute_training_metrics(q, t, i), JMET.compute_training_metrics(q, t, i))
    _same_metrics(
        TMET.compute_retrieval_metrics_final(q, t, i, prefix="W", t2i_weight=0.3, t2t_weight=0.7),
        JMET.compute_retrieval_metrics_final(q, t, i, prefix="W", t2i_weight=0.3, t2t_weight=0.7),
    )
    _same_metrics(TMET.compute_recall_at_k(sim, [1, 3]), JMET.compute_recall_at_k(sim, [1, 3]))
    _same_metrics(TMET.compute_mrr_and_mean_rank(sim), JMET.compute_mrr_and_mean_rank(sim))
    _same_metrics(TMET.compute_retrieval_metrics_fusion(sim, "F"), JMET.compute_retrieval_metrics_fusion(sim, "F"))
    ranks = np.arange(1, 41) % 7 + 1
    _same_metrics(TMET.metrics_from_ranks(ranks, (1, 2)), JMET.metrics_from_ranks(ranks, (1, 2)))
    m = TMET.compute_all_retrieval_metrics(q, t, i)
    assert TMET.average_mrr(m) == pytest.approx(JMET.average_mrr(m))
    assert "T2I_R@1" in m and "I2T_Mean_Rank" in m and "T2T_MRR" in m


def test_blocked_ranks_equal_dense(embeds, monkeypatch):
    q, t, i = (torch.as_tensor(x) for x in embeds)
    dense = TMET.diagonal_ranks(q @ i.T)
    for block in (7, 16, 64):
        assert torch.equal(TMET.diagonal_ranks_blocked(q, i, block=block), dense)
    blended = TMET.diagonal_ranks(0.25 * (q @ i.T) + 0.75 * (q @ t.T))
    assert torch.equal(TMET.blended_diagonal_ranks_blocked(q, t, i, 0.25, 0.75, block=9), blended)
    want = (TMET.compute_retrieval_metrics(q, i), TMET.compute_retrieval_metrics_final(q, t, i))
    monkeypatch.setattr(TMET, "_BLOCK_THRESHOLD", 10)  # the stripe path
    assert (TMET.compute_retrieval_metrics(q, i), TMET.compute_retrieval_metrics_final(q, t, i)) == want


def test_fusion_matches_jax(embeds):
    q, t, i = embeds
    n = q.shape[0]
    uuids = [f"u{k}" for k in range(n)]
    hits = _hits(n)
    for a, b in zip(TF.build_hit_indices(hits, uuids, uuids), JF.build_hit_indices(hits, uuids, uuids)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TF.build_hit_matrix(hits, uuids, uuids), JF.build_hit_matrix(hits, uuids, uuids)):
        np.testing.assert_array_equal(a, b)
    assert TF.uri_to_uuid("http://kg/x/u3") == JF.uri_to_uuid("http://kg/x/u3") == "u3"
    sim = q @ i.T
    for strategy, params in (("weighted", {"alpha": 0.6, "sparql_weight": 0.6}), ("additive", {"delta": 0.3}),
                             ("adaptive", {}), ("adaptive", {"size_thresholds": {2: 1.0, 10: 0.4}})):
        got = TF.fuse_clip_and_text2sparql(sim, hits, uuids, uuids, strategy, params).numpy()
        want = np.asarray(JF.fuse_clip_and_text2sparql(sim, hits, uuids, uuids, strategy, params))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=strategy)
        _same_metrics(TF.evaluate_retrieval(got), JF.evaluate_retrieval(want))
    with pytest.raises(ValueError, match="Unknown fusion strategy"):
        TF.fuse_clip_and_text2sparql(sim, hits, uuids, uuids, "nope")
    with pytest.raises(ValueError, match="similarity rows"):
        TF.weighted_fusion(sim[:3], hits, uuids, uuids)


def test_weighted_fusion_stripes_match_jax_and_the_dense_matrix(embeds):
    q, t, i = embeds
    n = q.shape[0]
    uuids = [f"u{k}" for k in range(n)]
    idx, mask, _ = TF.build_hit_indices(_hits(n, every=2), uuids, uuids)
    args = (q, t, i, idx, mask)
    kw = dict(t2i_weight=0.1, t2t_weight=0.9, alpha=0.7, sparql_weight=0.30000000000000004)
    got = TF.weighted_fusion_ranks_blocked(*args, block=16, **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(JF.weighted_fusion_ranks_blocked(*args, block=16, **kw)))
    hits, _ = TF.build_hit_matrix(_hits(n, every=2), uuids, uuids)
    dense = 0.7 * (0.1 * (q @ i.T) + 0.9 * (q @ t.T)) + kw["sparql_weight"] * hits
    np.testing.assert_array_equal(got, TMET.diagonal_ranks(dense).numpy())


def test_fusion_sweep_cell_by_cell(embeds):
    q, t, i = embeds
    n = q.shape[0]
    uuids = [f"u{k}" for k in range(n)]
    hits = _hits(n, every=2)
    got = TE.fusion_sweep(TE.EncodedDataset(i, q, t, uuids), hits, block=16, device="cpu")
    want = JE.fusion_sweep(JE.EncodedDataset(i, q, t, uuids), hits, block=16)
    assert list(got) == list(want) and len(got) == 18
    for cell in want:
        _same_metrics(got[cell], want[cell])


# -- the whole evaluation on one checkpoint ----------------------------------


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    model = JM.CLIP(ARCH, dtype=jnp.float32)
    params = JM.init_params(model, jax.random.PRNGKey(11))
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "tiny.pt")
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in flax_to_openai(params).items()}, ckpt)
    return model, params, ckpt


def _encoded_pair(world, encoder):
    model, params, ckpt = world
    use_fast, quantize = encoder != "flax", ("int8" if encoder == "int8" else None)
    jpipe = JPipe(j_source(N, image_size=32), JTok([]), image_size=32, context_length=16, num_workers=2)
    want = JE.encode_dataset(model, params, jpipe, MeshRuntime.create(), BATCH, use_fast=use_fast, quantize=quantize)
    tmodel = load_openai_state_dict(
        {k: np.asarray(v) for k, v in torch.load(ckpt).items()}, device="cpu", dtype=torch.float32)
    tpipe = TPipe(t_source(N, image_size=32), TTok([]), image_size=32, context_length=16, num_workers=2)
    got = TE.encode_dataset(tmodel, tpipe, BATCH, use_fast=use_fast, quantize=quantize)
    return tmodel, tpipe, got, want


def _safe_rows(q, c, err):
    """Rows whose diagonal is more than 2 * err (an embedding error bound)
    from every competitor's score: their rank cannot move."""
    s = q @ c.T
    gap = np.abs(s - np.diag(s)[:, None])
    np.fill_diagonal(gap, np.inf)
    return gap.min(axis=1) > 2 * 2 * err  # a score moves by up to 2 * err per side


def _assert_ranks_agree(got, want, err):
    pairs = (("T2I", "query", "image"), ("I2T", "image", "target"), ("T2T", "query", "target"))
    for task, a, b in pairs:
        safe = _safe_rows(getattr(want, a), getattr(want, b), err)
        assert safe.mean() > 0.5, task  # the check holds something
        gr = TMET.diagonal_ranks(getattr(got, a) @ getattr(got, b).T).numpy()
        wr = np.asarray(JMET.diagonal_ranks(getattr(want, a) @ getattr(want, b).T))
        np.testing.assert_array_equal(gr[safe], wr[safe], err_msg=task)


def test_run_full_evaluation_matches_jax(world, tmp_path):
    tmodel, tpipe, got, want = _encoded_pair(world, "flax")
    assert got.uuids == want.uuids
    for a in ("image", "query", "target"):
        np.testing.assert_allclose(getattr(got, a), getattr(want, a), atol=1e-4)
    err = max(np.abs(getattr(got, a) - getattr(want, a)).max() for a in ("image", "query", "target"))
    _assert_ranks_agree(got, want, float(err))
    hits = {f"uuid-{k:06d}": [f"uuid-{k:06d}"] for k in range(0, N, 7)}
    out = str(tmp_path / "report.json")
    report = TE.run_full_evaluation(tmodel, tpipe, batch_size=BATCH, text2sparql_results=hits, output_json=out)
    model, params, _ = world
    jpipe = JPipe(j_source(N, image_size=32), JTok([]), image_size=32, context_length=16, num_workers=2)
    jreport = JE.run_full_evaluation(model, params, jpipe, MeshRuntime.create(), batch_size=BATCH,
                                     text2sparql_results=hits)
    assert set(report) == set(jreport) == {"num_samples", "per_task", "weighted", "fusion_sweep"}
    assert report["num_samples"] == N and list(report["fusion_sweep"]) == list(jreport["fusion_sweep"])
    assert set(report["per_task"]) == set(jreport["per_task"])
    with open(out) as f:
        assert json.load(f)["per_task"] == pytest.approx(report["per_task"])
    with pytest.raises(ValueError, match="encoder"):
        TE.run_full_evaluation(tmodel, tpipe, encoder="fp16")


@pytest.mark.parametrize("encoder", ["fast", "int8"])
def test_encode_dataset_serving_encoders_match_jax(world, encoder):
    _, _, got, want = _encoded_pair(world, encoder)
    for a in ("image", "query", "target"):
        x, y = getattr(got, a), getattr(want, a)
        if encoder == "fast":
            np.testing.assert_allclose(x, y, atol=1e-4)
        assert np.sum(x * y, axis=1).min() > 0.999, a


def test_cli_evaluate_matches_the_jax_cli(world, tmp_path, monkeypatch):
    monkeypatch.setitem(JM.ARCHS, "tiny", ARCH)
    t2s = str(tmp_path / "t2s.json")
    with open(t2s, "w") as f:
        json.dump({f"uuid-{k:06d}": [f"http://kg/artefact/uuid-{k:06d}"] for k in range(0, N, 7)}, f)
    common = ["--model.name=tiny", f"--model.checkpoint={world[2]}", "--model.dtype=float32",
              f"--data.dataset=synthetic:{N}", "--data.image_size=32", "--data.context_length=16",
              f"--eval.batch_size={BATCH}", f"--t2s_results={t2s}"]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    want = j_cli.main(common + [f"--eval.output_dir={jdir}"])
    got = t_cli.main(common + [f"--eval.output_dir={tdir}", "--device=cpu"])
    assert os.listdir(tdir) == os.listdir(jdir) == ["eval_tiny_finetuned.json"]
    assert set(got) == set(want)
    _, _, enc_t, enc_j = _encoded_pair(world, "flax")
    err = max(np.abs(getattr(enc_t, a) - getattr(enc_j, a)).max() for a in ("image", "query", "target"))
    all_safe = all(_safe_rows(getattr(enc_j, a), getattr(enc_j, b), float(err)).all()
                   for a, b in (("query", "image"), ("image", "target"), ("query", "target")))
    for part in ("per_task", "weighted"):
        assert set(got[part]) == set(want[part])
        if all_safe:  # no rank can move: the metrics are the JAX CLI's
            _same_metrics(got[part], want[part])
    assert list(got["fusion_sweep"]) == list(want["fusion_sweep"])


def test_cli_evaluate_refuses_without_a_card_and_the_compile_cache(tmp_path):
    args = [f"--data.dataset=synthetic:4", f"--eval.output_dir={tmp_path}"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device=cpu"):
            t_cli.main(args)  # --device defaults to cuda and never falls back
    with pytest.raises(NotImplementedError, match="compile_cache"):
        t_cli.main(args + ["--device=cpu", "--eval.compile_cache=/x"])
