"""The port's mined hard negatives (``train.negatives``,
``DataPipeline.negative_target_ids``, the trainer's table and
``cli.mine_negatives``) held to the JAX package's.

Mining returns JAX's indices exactly: on embeddings of small integers every
product is exact, so the ties are real and both order them value
descending, then row ascending; on seeded Gaussian rows too, with ``n`` no
multiple of the block. The ``.npz`` tables cross both ways; three steps with
negatives (and with GradCache) match the JAX trainer's at rtol / atol 1e-4;
the guards raise; ``cli.mine_negatives --device=cpu`` over a JAX-written
flax ``.npz`` writes JAX's table, but for rows whose candidates lie within
float noise of each other.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.cli import mine_negatives as j_cli
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import save_params_npz
from knowledge_enhanced_multimodal_retrieval_tpu.train import negatives as JN
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import mine_negatives as t_cli
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.common import build_pipeline
from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval.evaluator import encode_dataset
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import (
    load_clip_state_dict,
    load_openai_state_dict,
    openai_state_dict,
)
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import negatives as TN
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import config_from_argv
from tests.test_torch_train import assert_same_params, cfgs, jax_openai, port_model, run_both, world  # noqa: F401

NEAR_TIE = 1e-5  # card- or package-level f32 noise in a 16-d cosine


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread (the lane runs six workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("data, n, block", [("integers", 37, 8), ("integers", 50, 2048), ("gaussian", 45, 16)])
def test_mining_matches_jax(data, n, block):
    rng = np.random.default_rng(n)
    if data == "integers":  # exact products, many ties
        a, c = (rng.integers(-2, 3, (n, 6)).astype(np.float32) for _ in range(2))
    else:
        a, c = (rng.standard_normal((n, 16)).astype(np.float32) for _ in range(2))
    for k in (1, 5, n - 1):
        want = JN.mine_hard_negatives(a, c, k, block=block)
        got = TN.mine_hard_negatives(a, c, k, block=block)
        assert got.dtype == np.int32 and got.shape == (n, k)
        np.testing.assert_array_equal(got, want, err_msg=f"{data} k={k}")
        assert not np.any(got == np.arange(n)[:, None])
    if data == "integers":
        scores = a @ c.T
        np.fill_diagonal(scores, -np.inf)
        assert (np.sort(scores, axis=1)[:, :-1] == np.sort(scores, axis=1)[:, 1:]).any()  # ties were there


def test_mining_validates_args():
    x = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="row-aligned"):
        TN.mine_hard_negatives(x, np.zeros((5, 3), np.float32), 2)
    for k in (0, 4):
        with pytest.raises(ValueError, match="0 < k"):
            TN.mine_hard_negatives(x, x, k)


def mined_table(pipe, m=4, seed=0):
    rng = np.random.default_rng(seed)
    n = len(pipe)
    idx = np.stack([rng.permutation(np.delete(np.arange(n), i))[:m] for i in range(n)]).astype(np.int32)
    return idx, [pipe.source[i]["uuid"] for i in range(n)]


def test_files_and_digest_cross_both_ways(world, tmp_path):
    jpipe = world[2]
    idx, uuids = mined_table(jpipe)
    assert TN.uuid_digest(uuids) == JN.uuid_digest(uuids) != TN.uuid_digest(uuids[::-1])
    JN.save_negatives(str(tmp_path / "j.npz"), idx, uuids, meta={"by": "query", "k": 4})
    got_idx, got_uuids = TN.load_negatives(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(got_idx, idx)
    assert got_uuids == uuids
    TN.save_negatives(str(tmp_path / "t.npz"), idx, uuids, meta={"by": "image", "k": 4})
    back_idx, back_uuids = JN.load_negatives(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(back_idx, idx)
    assert back_uuids == uuids
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        meta = json.loads(str(t["__meta__"]))
        assert meta == {"digest": JN.uuid_digest(uuids), "n": len(uuids), "by": "image", "k": 4}
    with pytest.raises(ValueError, match="aligned"):
        TN.save_negatives(str(tmp_path / "bad.npz"), idx[:3], uuids)


def test_negative_target_ids_match(world):
    _, _, jpipe, tpipe, _ = world
    table, _ = mined_table(jpipe)
    rows = np.array([3, 7, 1, 63])
    for k in (1, 3):
        got = tpipe.negative_target_ids(rows, table, k)
        np.testing.assert_array_equal(got, jpipe.negative_target_ids(rows, table, k))
        assert got.shape == (4, k, 16)


@pytest.mark.parametrize("case", ["negatives", "negatives_gradcache"])
def test_steps_with_negatives_match_jax(world, tmp_path, case):
    idx, uuids = mined_table(world[2])
    path = str(tmp_path / "neg.npz")
    JN.save_negatives(path, idx, uuids)
    kw = dict(hard_negatives=path, hard_negatives_k=3)
    if case == "negatives_gradcache":
        kw["grad_cache_chunks"] = 2
    jm, tm, jstate, tt = run_both(world, tmp_path, **kw)
    for i, (j, t) in enumerate(zip(jm, tm)):
        for key in j:
            assert t[key] == pytest.approx(j[key], rel=1e-4, abs=1e-4), (i, key, t[key], j[key])
    assert_same_params(openai_state_dict(tt.model), jax_openai(jstate["params"]))
    assert tt._device_batch(world[4][0])["neg_ids"].shape == (16, 3, 16)


def test_trainer_guards(world, tmp_path):
    arch, params, _, tpipe, batches = world
    idx, uuids = mined_table(tpipe)
    path = str(tmp_path / "neg.npz")

    def trainer(**kw):
        return TT.CLIPTrainer(port_model(arch, params), tpipe, None, cfgs(str(tmp_path), hard_negatives=path, **kw)[1],
                              out_dir=str(tmp_path))

    TN.save_negatives(path, idx[:10], uuids[:10])
    with pytest.raises(ValueError, match="re-mine"):
        trainer(hard_negatives_k=2)
    TN.save_negatives(path, idx, uuids)
    with pytest.raises(ValueError, match="exceeds"):
        trainer(hard_negatives_k=99)
    with pytest.raises(ValueError, match="distill step"):
        trainer(hard_negatives_k=2, distill_teacher="teacher.npz")
    TN.save_negatives(path, idx, uuids[::-1])
    with pytest.raises(ValueError, match="different/reordered"):
        trainer(hard_negatives_k=2)._device_batch(batches[0])


def test_cli_mine_negatives_matches_jax(world, tmp_path, monkeypatch):
    arch, params, *_ = world
    monkeypatch.setitem(JM.ARCHS, "tiny-neg", arch)
    monkeypatch.setitem(TM.ARCHS, "tiny-neg", TM.CLIPArch(**dataclasses.asdict(arch)))
    ckpt = str(tmp_path / "flax.npz")
    save_params_npz(params, ckpt)
    argv = ["--data.dataset=synthetic:40", "--data.image_size=32", "--data.context_length=16", "--model.name=tiny-neg",
            "--model.dtype=float32", f"--model.checkpoint={ckpt}", "--eval.batch_size=8", "--k", "5"]
    for by in ("query", "image"):
        want, want_uuids = JN.load_negatives(j_cli.main(argv + ["--by", by, "--out", str(tmp_path / f"j_{by}.npz")]))
        got, got_uuids = TN.load_negatives(t_cli.main(argv + ["--by", by, "--device=cpu",
                                                              "--out", str(tmp_path / f"t_{by}.npz")]))
        assert got_uuids == want_uuids and got.shape == want.shape == (40, 5)
        # exact ties (equal target texts) must order as JAX orders them; a row whose top k + 1 hold two distinct
        # scores within float noise of each other may order them either way
        model = load_openai_state_dict(load_clip_state_dict(ckpt), dtype=torch.float32,
                                       arch=TM.ARCHS["tiny-neg"])
        cfg = config_from_argv(argv[:-2])
        enc = encode_dataset(model, build_pipeline(cfg, cfg.data.split_train), batch_size=8)
        scores = (enc.query if by == "query" else enc.image) @ enc.target.T
        np.fill_diagonal(scores, -np.inf)
        top = -np.sort(-scores, axis=1)[:, :6]
        gap = -np.diff(top, axis=1)
        near = ((gap > 0) & (gap < NEAR_TIE)).any(axis=1)
        assert near.sum() <= 4 and (gap == 0).any(), (near.sum(), by)
        np.testing.assert_array_equal(got[~near], want[~near], err_msg=by)
