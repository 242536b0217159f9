"""The port's training loop end to end, its checkpoints and its CLIs.

Whole ``CLIPTrainer`` runs beside the JAX trainer on a one-device mesh (the
same flax init, the same synthetic split, validated on itself): epoch means,
validation metrics and the best epoch. Resume is bit-identical on the CPU;
the checkpoint sidecar lands after its data; ``cli.train --device=cpu`` and
``cli.export`` in all three layouts read back through
``models.convert.load_clip_state_dict``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.data.datasets import DataPipeline as JPipe
from knowledge_enhanced_multimodal_retrieval_tpu.data.datasets import make_synthetic_source as j_source
from knowledge_enhanced_multimodal_retrieval_tpu.data.tokenizer import CLIPTokenizer as JTok
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.train import trainer as JT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import export as t_export
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import train as t_train
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import DataPipeline as TPipe
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import make_synthetic_source as t_source
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_clip_state_dict, openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import checkpoint as TC
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
from tests.test_torch_train import MERGES, cfgs, one_device, port_model, tiny_arch
from tests.torch_train_fixtures import adamw_format

N, BATCH = 64, 16

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread (the lane runs six workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def world():
    tok = JTok(MERGES)
    arch = tiny_arch(tok.vocab_size)
    params = JM.init_params(JM.CLIP(arch, dtype=jnp.float32), jax.random.PRNGKey(0))
    jpipe = JPipe(j_source(N, image_size=32), tok, image_size=32, context_length=16, num_workers=2)
    tpipe = TPipe(t_source(N, image_size=32), TTok(MERGES), image_size=32, context_length=16, num_workers=2)
    return arch, params, jpipe, tpipe


def port_trainer(world, tmp, **kw):
    arch, params, _, tpipe = world
    return TT.CLIPTrainer(port_model(arch, params), tpipe, tpipe, cfgs(str(tmp), **kw)[1], out_dir=str(tmp))


def test_two_epoch_run_matches_jax(world, tmp_path):
    arch, params, jpipe, _ = world
    jcfg, _ = cfgs(str(tmp_path / "j"))
    want = JT.CLIPTrainer(JM.CLIP(arch, dtype=jnp.float32), params, jpipe, jpipe, jcfg, rt=one_device(),
                          out_dir=str(tmp_path / "j")).train()
    got = port_trainer(world, tmp_path / "t").train()
    assert (got["epochs_run"], got["best_epoch"], got["preempted"]) == (want["epochs_run"], want["best_epoch"], False)
    assert got["best_metric"] == pytest.approx(want["best_metric"], rel=1e-4)
    for g, w in zip(got["history"], want["history"]):
        assert g["steps"] == w["steps"] == N // BATCH
        for part in ("train", "val"):
            assert set(g[part]) == set(w[part]), part
            for k in w[part]:
                assert g[part][k] == pytest.approx(w[part][k], rel=1e-4, abs=1e-4), (part, k)
    ckpt = tmp_path / "t" / "ckpt"
    assert {p.name for p in ckpt.iterdir()} == {f"checkpoint_{r}.{e}" for r in ("latest", "best")
                                                for e in ("pt", "meta.json")}
    lines = (tmp_path / "t" / "train_metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1]
    assert json.loads((tmp_path / "t" / "train_final.json").read_text())["epochs_run"] == 2


def test_resume_is_bit_identical(world, tmp_path):
    """One epoch, a resume, one more == two straight epochs; logit_scale untouched."""
    straight = port_trainer(world, tmp_path / "a", epochs=2)
    straight.train()
    first = port_trainer(world, tmp_path / "b", epochs=1)
    first.train()
    resumed = port_trainer(world, tmp_path / "b", epochs=2, resume=True)
    assert resumed.start_epoch == 1 and resumed.state.step == N // BATCH
    resumed.train()
    assert resumed.state.step == straight.state.step == 2 * N // BATCH
    want = dict(straight.model.named_parameters())
    for n, p in resumed.model.named_parameters():
        assert torch.equal(p, want[n]), n
    assert float(resumed.model.logit_scale.detach()) == pytest.approx(float(np.log(1 / 0.07)), rel=1e-6)
    a, b = straight.state.optimizer.state_dict(), resumed.state.optimizer.state_dict()
    assert a["count"] == b["count"] == 2 * N // BATCH


def test_resume_reads_the_earlier_optimizer_format(world, tmp_path):
    """A latest checkpoint whose optimizer state is in the earlier format
    resumes: one epoch, its optimizer state rewritten so, a resume and one
    more epoch == two straight epochs. A state of neither format is a
    ValueError naming the keys it expects."""
    straight = port_trainer(world, tmp_path / "a", epochs=2)
    straight.train()
    first = port_trainer(world, tmp_path / "b", epochs=1)
    first.train()
    ckpt_dir = str(tmp_path / "b" / "ckpt")
    state, meta = TC.load_checkpoint(ckpt_dir, "latest")
    state["opt_state"] = adamw_format(first.state.optimizer)
    TC.save_checkpoint(ckpt_dir, "latest", state, meta, wait=True)
    resumed = port_trainer(world, tmp_path / "b", epochs=2, resume=True)
    assert resumed.start_epoch == 1 and resumed.state.step == N // BATCH
    resumed.train()
    want = dict(straight.model.named_parameters())
    for n, p in resumed.model.named_parameters():
        assert torch.equal(p, want[n]), n
    with pytest.raises(ValueError, match="exp_avg"):
        resumed.state.optimizer.load_state_dict({"count": 0, "mini_step": 0, "moments": {}})


def test_preemption_salvages_a_resumable_checkpoint(world, tmp_path):
    t = port_trainer(world, tmp_path, preempt_check_every=1)
    guard = TT.PreemptionGuard(install=False)
    guard.trigger()
    result = t.train(guard)
    assert result["preempted"] and result["history"][0]["steps"] == 1
    again = port_trainer(world, tmp_path, resume=True)
    assert again.start_epoch == 0 and again.state.step == 1


def test_sidecar_lands_after_its_data(tmp_path, monkeypatch):
    order = []
    real = os.replace
    monkeypatch.setattr(TC.os, "replace", lambda src, dst: (order.append(os.path.basename(dst)), real(src, dst)))
    state = {"params": {"w": torch.arange(4.0)}, "step": 3}
    TC.save_checkpoint(str(tmp_path), "latest", state, {"epoch": 0})
    state["params"]["w"] += 1  # the snapshot was taken at the call
    TC.save_checkpoint(str(tmp_path), "latest", state, {"epoch": 1}, wait=True)
    assert order == ["checkpoint_latest.pt", "checkpoint_latest.meta.json"] * 2
    got, meta = TC.load_checkpoint(str(tmp_path), "latest")
    assert meta == {"epoch": 1} and got["step"] == 3 and torch.equal(got["params"]["w"], torch.arange(4.0) + 1)
    assert TC.checkpoint_exists(str(tmp_path), "latest") and not TC.checkpoint_exists(str(tmp_path), "best")
    # latest-wins: an older save's sidecar never overwrites a newer one
    path = os.path.join(str(tmp_path), "checkpoint_latest.pt")
    TC._write_meta(path, json.dumps({"epoch": -5}), seq=-1)
    assert TC.load_checkpoint(str(tmp_path), "latest")[1] == {"epoch": 1}


def test_load_params_only_prefers_the_ema_shadow(world, tmp_path):
    t = port_trainer(world, tmp_path, ema_decay=0.5, epochs=1)
    t.train()
    got = TC.load_params_only(str(tmp_path / "ckpt"), "best")
    ema = t.eval_params()
    assert set(got) == set(ema)
    assert all(torch.equal(got[n], ema[n]) for n in ema)
    assert any(not torch.equal(got[n], p) for n, p in t.model.named_parameters())
    plain = {"params": {"w": torch.ones(2)}, "step": 0}
    TC.save_checkpoint(str(tmp_path / "p"), "best", plain, {}, wait=True)
    assert torch.equal(TC.load_params_only(str(tmp_path / "p"), "best")["w"], torch.ones(2))


def test_cli_train_and_export_all_formats(tmp_path, monkeypatch):
    """``cli.train --device=cpu`` on synthetic:32, then ``cli.export`` of the
    best checkpoint as OpenAI ``.pt``, flax ``.npz`` and an HF directory:
    each reads back through ``load_clip_state_dict`` to the trained weights."""
    vocab = TTok([]).vocab_size  # the byte tokenizer of synthetic data
    arch = TM.CLIPArch(**{**tiny_arch(vocab).__dict__})
    monkeypatch.setitem(TM.ARCHS, "tiny-train", arch)
    ckpt = str(tmp_path / "ckpt")
    result = t_train.main([
        "--device=cpu", "--model.name=tiny-train", "--model.dtype=float32", "--data.dataset=synthetic:32",
        "--data.image_size=32", "--data.context_length=16", "--data.num_workers=2", "--train.batch_size=8",
        "--train.epochs=2", "--train.lr=1e-3", "--train.log_every=1", f"--train.checkpoint_dir={ckpt}",
        f"--eval.output_dir={tmp_path / 'out'}",
    ])
    assert result["epochs_run"] == 2 and result["history"][0]["steps"] == 4
    want = t_export.module_to_openai(TC.load_params_only(ckpt, "best"))
    assert set(want) == set(openai_state_dict(TM.build_model("tiny-train", dtype=torch.float32)))
    for fmt, out in (("openai", "w.pt"), ("npz", "w.npz"), ("hf", "hf")):
        path = t_export.main(["--model.name=tiny-train", "--train-dir", ckpt, "--role=best", f"--format={fmt}",
                              "--out", str(tmp_path / out)])
        if fmt == "hf":
            transformers = pytest.importorskip("transformers")
            sd = transformers.CLIPModel.from_pretrained(path).state_dict()
            path = str(tmp_path / "hf.pt")
            torch.save(sd, path)
        got = load_clip_state_dict(path)
        assert set(got) == set(want), fmt
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{fmt} {k}")
    # re-layout of any readable checkpoint: the OpenAI .pt back to flax .npz
    out = t_export.main([f"--model.checkpoint={tmp_path / 'w.pt'}", "--format=npz", f"--out={tmp_path / 'again.npz'}"])
    got = load_clip_state_dict(out)
    assert all(np.array_equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("argv, item", [
    (["--mesh.data_parallel=8"], "data"),
    (["--mesh.data_parallel=8", "--mesh.fsdp=true"], "fsdp"),
])
def test_cli_refusals(tmp_path, monkeypatch, argv, item):
    """A ``--mesh.*`` layout of more than one device trains: ``cli.train
    --device=cpu`` over ``cpu`` repeated (the data-parallel step, or FSDP's
    blocks) follows the JAX CLI over its 8 virtual devices, both from one
    flax checkpoint: each epoch's mean loss and monitor at 1e-4."""
    from knowledge_enhanced_multimodal_retrieval_tpu.cli import train as j_train
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import save_params_npz

    vocab = TTok([]).vocab_size
    arch = tiny_arch(vocab)
    monkeypatch.setitem(JM.ARCHS, "tiny-mesh", arch)
    monkeypatch.setitem(TM.ARCHS, "tiny-mesh", TM.CLIPArch(**arch.__dict__))
    save_params_npz(TM.build_model("tiny-mesh", dtype=torch.float32, seed=3), str(tmp_path / "w.npz"))
    common = ["--model.name=tiny-mesh", "--model.dtype=float32", f"--model.checkpoint={tmp_path / 'w.npz'}",
              "--data.dataset=synthetic:32", "--data.image_size=32", "--data.context_length=16",
              "--data.num_workers=1", "--train.batch_size=16", "--train.epochs=1", "--train.lr=1e-3",
              "--train.global_negatives=true", *argv]
    got = t_train.main(["--device=cpu", *common, f"--train.checkpoint_dir={tmp_path / 't'}",
                        f"--eval.output_dir={tmp_path / 'to'}"])
    want = j_train.main([*common, f"--train.checkpoint_dir={tmp_path / 'j'}", f"--eval.output_dir={tmp_path / 'jo'}"])
    for g, w in zip(got["history"], want["history"]):
        assert g["steps"] == w["steps"] == 2
        assert g["train"]["loss"] == pytest.approx(w["train"]["loss"], rel=1e-4, abs=1e-4), item
        assert g["monitor"] == pytest.approx(w["monitor"], rel=1e-4, abs=1e-4), item


def test_cli_train_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device=cpu"):
        t_train.main(["--data.dataset=synthetic:8"])


def test_train_bench_counts_flops_and_runs_on_the_cpu(tmp_path):
    """The analytic FLOPs of a ViT-L/14 batch-64 step (3.0e13 vision, 5.0e12
    text, ~1.3e12 attention scores: 3x the forward; 4x with remat), and the
    script's control flow at a tiny size (no device metric on the CPU)."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import train_bench as TB

    f = TB.forward_flops(TM.ARCHS["ViT-L/14"], 64)
    assert 3 * f["vision"] == pytest.approx(2.98e13, rel=0.01)
    assert 3 * f["text"] == pytest.approx(5.02e12, rel=0.01)
    assert 3 * f["attention"] == pytest.approx(1.33e12, rel=0.01)
    assert TB.step_flops(TM.ARCHS["ViT-L/14"], 64, True) == pytest.approx(4 / 3 * TB.step_flops(TM.ARCHS["ViT-L/14"], 64, False))
    out = TB.main(["--quick", "--device=cpu", "--breakdown", "--steps", "2", "--out", str(tmp_path / "tb.json")])
    entry = out["entries"][0]
    assert out["device"] == "cpu" and "host_ms" in entry and "step_ms" not in entry and "mfu" not in entry
    assert np.isfinite(entry["loss_final"]) and set(entry["breakdown"]) == {"image_tower_fwd", "text_towers_fwd",
                                                                             "fwd_loss", "fwd_bwd"}
    assert json.loads((tmp_path / "tb.json").read_text())["entries"][0]["model"] == "quick"
