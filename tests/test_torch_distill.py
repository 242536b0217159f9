"""The port's distillation (``train.distill``, ``cli.distill``) held to the
JAX package's.

``distill_loss`` matches on ``loss`` / ``loss_kd`` / ``loss_embed`` (equal
dimensions with the cosine term, and a 24-d teacher for a 16-d student with
it off) to 1e-5; the dimension refusal raises; the encoded-dataset file
crosses both ways and ``TeacherBank`` returns the same rows; three distill
steps match the JAX trainer's at rtol / atol 1e-4; ``cli.distill
--device=cpu`` runs both stages (its teacher file equal to the JAX CLI's on
the same flax checkpoint) and the second alone from a JAX-written teacher
file.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.cli import distill as j_cli
from knowledge_enhanced_multimodal_retrieval_tpu.eval.evaluator import EncodedDataset as JEnc
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import save_params_npz
from knowledge_enhanced_multimodal_retrieval_tpu.train import distill as JD
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import distill as t_cli
from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval.evaluator import EncodedDataset as TEnc
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import distill as TD
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
from tests.test_torch_train import assert_same_params, cfgs, jax_openai, port_model, run_both, world  # noqa: F401

LOSS_TOL = dict(rel=1e-5, abs=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread (the lane runs six workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def normed(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("t_dim, embed_weight", [(16, 0.5), (16, 0.0), (24, 0.0)])
def test_distill_loss_matches_jax(t_dim, embed_weight):
    rng = np.random.default_rng(t_dim)
    s = [normed(rng, 12, 16) for _ in range(3)]
    t = [normed(rng, 12, t_dim) for _ in range(3)]
    kw = dict(temperature=0.07, t2i_weight=0.7, t2t_weight=0.3, kd_weight=1.3, embed_weight=embed_weight)
    j_loss, j_m = JD.distill_loss(*(jnp.asarray(x) for x in s + t), **kw)
    t_loss, t_m = TD.distill_loss(*(torch.from_numpy(x) for x in s + t), **kw)
    assert set(t_m) == set(j_m) == {"loss", "loss_kd", "loss_embed"}
    for k in j_m:
        assert float(t_m[k]) == pytest.approx(float(j_m[k]), **LOSS_TOL), k
    assert float(t_loss) == pytest.approx(float(j_loss), **LOSS_TOL)
    # zero at a match
    zero, m = TD.distill_loss(*(torch.from_numpy(x) for x in s + s), embed_weight=0.5)
    assert abs(float(m["loss_kd"])) < 1e-6 and abs(float(zero)) < 1e-6


def teacher_file(world, tmp, dim, writer="jax"):
    """Teacher rows for every uuid of the split, written by either package."""
    jpipe = world[2]
    uuids = [jpipe.source[i]["uuid"] for i in range(len(jpipe))]
    rng = np.random.default_rng(dim)
    rows = [normed(rng, len(uuids), dim) for _ in range(3)]
    path = str(tmp / f"teacher_{dim}_{writer}.npz")
    (JD.save_encoded_dataset(path, JEnc(*rows, uuids)) if writer == "jax"
     else TD.save_encoded_dataset(path, TEnc(*rows, uuids)))
    return path, rows, uuids


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_encoded_dataset_and_bank_cross_both_ways(world, tmp_path, writer):
    path, rows, uuids = teacher_file(world, tmp_path, 16, writer)
    for load in (JD.load_encoded_dataset, TD.load_encoded_dataset):
        enc = load(path)
        assert enc.uuids == uuids
        for got, want in zip((enc.image, enc.query, enc.target), rows):
            np.testing.assert_array_equal(got, want)
    pick = [uuids[5], uuids[0], uuids[40]]
    t_rows = TD.TeacherBank(TD.load_encoded_dataset(path)).rows(pick)
    j_rows = JD.TeacherBank(JD.load_encoded_dataset(path)).rows(pick)
    for a, b in zip(t_rows, j_rows):
        np.testing.assert_array_equal(a, b)
    assert TD.TeacherBank(TD.load_encoded_dataset(path)).dim == 16
    with pytest.raises(KeyError, match="not in the teacher"):
        TD.TeacherBank(TD.load_encoded_dataset(path)).rows(["no-such-uuid"])
    with pytest.raises(ValueError, match="duplicate"):
        TD.TeacherBank(TEnc(rows[0][:2], rows[1][:2], rows[2][:2], [uuids[0], uuids[0]]))
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]  # atomic replace leaves no temporary


def test_dimension_refusal(world, tmp_path):
    arch, params, _, tpipe, _ = world
    path, *_ = teacher_file(world, tmp_path, 24)
    _, tcfg = cfgs(str(tmp_path), distill_teacher=path, distill_embed_weight=0.5)
    with pytest.raises(ValueError, match="distill_embed_weight=0"):
        TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, out_dir=str(tmp_path))
    with pytest.raises(ValueError, match="full-fine-tune"):
        TT.CLIPTrainer(port_model(arch, params), tpipe, None,
                       dataclasses.replace(tcfg, distill_embed_weight=0.0, ema_decay=0.9), out_dir=str(tmp_path))


@pytest.mark.parametrize("t_dim, embed_weight", [(16, 0.5), (24, 0.0)])
def test_distill_steps_match_jax(world, tmp_path, t_dim, embed_weight):
    path, *_ = teacher_file(world, tmp_path, t_dim)
    jm, tm, jstate, tt = run_both(world, tmp_path, distill_teacher=path, distill_embed_weight=embed_weight,
                                  distill_kd_weight=1.5)
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert set(t) == set(j) == {"loss", "loss_kd", "loss_embed", "grad_norm"}
        for key in j:
            assert t[key] == pytest.approx(j[key], rel=1e-4, abs=1e-4), (i, key, t[key], j[key])
    assert_same_params(openai_state_dict(tt.model), jax_openai(jstate["params"]))
    assert tt._device_batch(world[4][0])["t_img"].shape == (16, t_dim)


def test_cli_distill_both_stages_and_the_second_alone(world, tmp_path, monkeypatch):
    arch, params, *_ = world
    monkeypatch.setitem(JM.ARCHS, "tiny-kd", arch)
    monkeypatch.setitem(TM.ARCHS, "tiny-kd", TM.CLIPArch(**dataclasses.asdict(arch)))
    ckpt = str(tmp_path / "teacher.npz")
    save_params_npz(params, ckpt)
    common = ["--data.dataset=synthetic:24", "--data.image_size=32", "--data.context_length=16",
              "--model.name=tiny-kd", "--model.dtype=float32", "--eval.batch_size=8", "--train.epochs=1",
              "--train.batch_size=8"]
    teacher = ["--teacher-name=tiny-kd", f"--teacher-checkpoint={ckpt}"]
    want = j_cli.main(common + teacher + [f"--eval.output_dir={tmp_path}/j", f"--train.checkpoint_dir={tmp_path}/jck"])
    got = t_cli.main(common + teacher + ["--device=cpu", f"--eval.output_dir={tmp_path}/t",
                                         f"--train.checkpoint_dir={tmp_path}/tck"])
    assert got["teacher_embeddings"] == f"{tmp_path}/t/teacher_train.npz" and np.isfinite(got["best_metric"])
    assert got["epochs_run"] == 1 and {"loss", "loss_kd", "loss_embed", "grad_norm"} == set(got["history"][0]["train"])
    t_enc, j_enc = TD.load_encoded_dataset(got["teacher_embeddings"]), JD.load_encoded_dataset(want["teacher_embeddings"])
    assert t_enc.uuids == j_enc.uuids
    for a, b in ((t_enc.image, j_enc.image), (t_enc.query, j_enc.query), (t_enc.target, j_enc.target)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # the second stage alone, from the JAX package's teacher file
    again = t_cli.main(common + [f"--teacher-embeddings={want['teacher_embeddings']}", "--device=cpu",
                                 f"--eval.output_dir={tmp_path}/t2", f"--train.checkpoint_dir={tmp_path}/tck2"])
    assert again["teacher_embeddings"] == want["teacher_embeddings"] and np.isfinite(again["best_metric"])
    assert not os.path.exists(f"{tmp_path}/t2/teacher_train.npz")
    with pytest.raises(ValueError, match="--teacher-name"):
        t_cli.main(common + ["--device=cpu", f"--eval.output_dir={tmp_path}/t3"])
