"""The port's LoRA (``train.lora``) held to the JAX package's.

Adapters cross between the packages through the adapter ``.npz`` (flax
paths, ``a`` ``[in, r]``, ``b`` ``[r, out]``), written by either and read by
the other. ``lora_merge`` of JAX's adapters on JAX's base matches JAX's to
1e-6; three LoRA steps from JAX's initial adapters match the JAX trainer's
(losses, ``grad_norm``, adapters at rtol / atol 1e-4) with the base
unchanged; ``--model.adapters`` (``cli.common.build_model``, ``cli.export``)
gives JAX ``merge_adapters``' parameters; ``cli.train`` with LoRA writes the
best epoch's adapters.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.cli import common as JC
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import save_params_npz
from knowledge_enhanced_multimodal_retrieval_tpu.train import lora as JL
from knowledge_enhanced_multimodal_retrieval_tpu.train import trainer as JT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import common as TC
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import export as t_export
from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli import train as t_train
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_clip_state_dict, openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import checkpoint as TCK
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import lora as TL
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import config_from_argv
from tests.test_torch_train import TOL, cfgs, jax_openai, one_device, port_model, world  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread (the lane runs six workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_adapters(params, seed, rank, targets, shift=0.0):
    ad = JL.lora_init(jax.random.PRNGKey(seed), params, rank=rank, targets=targets)
    return jax.tree_util.tree_map(lambda x: x + shift, ad)


def to_port(tmp, ad, meta=None):
    """JAX adapters -> the port's, through JAX's adapter file."""
    path = str(tmp / f"jax_ad_{len(os.listdir(tmp))}.npz")
    JL.save_adapters(path, ad, meta or {"rank": 1, "alpha": 1.0})
    return TL.load_adapters(path)[0], path


@pytest.mark.parametrize("targets, n_kinds", [("attn", 2), ("mlp", 2), ("all", 4)])
def test_lora_init_targets_and_shapes(world, targets, n_kinds):
    arch, params, *_ = world
    named = dict(port_model(arch, params).named_parameters())
    ad = TL.lora_init(named, 3, targets, torch.Generator().manual_seed(0))
    names = TL.adapted_names(ad)
    assert len(names) == n_kinds * 2 and all(TL.is_target(n, targets) for n in names)  # one layer a tower
    for n in names:
        d_out, d_in = named[n].shape
        assert ad[n + ".a"].shape == (d_in, 3) and ad[n + ".b"].shape == (3, d_out)
        assert not ad[n + ".b"].any()
    # the same kernels JAX adapts
    jad = JL.lora_init(jax.random.PRNGKey(0), params, rank=3, targets=targets)
    jpaths = {"/".join(JL._path_names(p))[: -len("/a")]
              for p, _ in jax.tree_util.tree_flatten_with_path(jad)[0] if JL._path_names(p)[-1] == "a"}
    assert {TL.flax_path(n) for n in names} == jpaths
    assert TL.lora_param_count(ad) == JL.lora_param_count(jad)
    # A ~ N(0, 1/r): seeded, and merged == base at init
    again = TL.lora_init(named, 3, targets, torch.Generator().manual_seed(0))
    assert all(torch.equal(ad[k], again[k]) for k in ad)
    merged = TL.lora_merge(named, ad, 2.0)
    assert all(torch.equal(merged[n], named[n]) for n in named)


def test_lora_validation_errors(world):
    arch, params, *_ = world
    named = dict(port_model(arch, params).named_parameters())
    with pytest.raises(ValueError, match="targets"):
        TL.lora_init(named, 2, "everything")
    with pytest.raises(ValueError, match="rank"):
        TL.lora_init(named, 0)


def test_lora_merge_matches_jax(world, tmp_path):
    arch, params, *_ = world
    ad = jax_adapters(params, 1, 2, "all", shift=0.1)
    want = jax_openai(JL.lora_merge(params, ad, 0.5))
    port_ad, _ = to_port(tmp_path, ad)
    named = dict(port_model(arch, params).named_parameters())
    got = TL.lora_merge(named, port_ad, 0.5)
    got = {TL.openai_key(n): v.detach().numpy() for n, v in got.items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].reshape(want[k].shape), want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    # the host merge (numpy, OpenAI layout): JAX's lora_merge_host arithmetic
    host = TL.lora_merge_host(jax_openai(params), {k: v.numpy() for k, v in port_ad.items()}, 0.5)
    want_host = jax_openai(JL.lora_merge_host(jax.tree_util.tree_map(np.asarray, params), ad, 0.5))
    for k in want_host:
        np.testing.assert_array_equal(host[k], want_host[k], err_msg=k)


def test_adapter_files_cross_both_ways(world, tmp_path):
    arch, params, *_ = world
    ad = jax_adapters(params, 3, 2, "all", shift=0.25)
    port_ad, path = to_port(tmp_path, ad, {"rank": 2, "alpha": 4.0, "targets": "all"})
    assert TL.load_adapters(path)[1] == {"rank": 2, "alpha": 4.0, "targets": "all"}
    for p, leaf in jax.tree_util.tree_flatten_with_path(ad)[0]:
        names = JL._path_names(p)
        got = port_ad[f"{TL.module_name('/'.join(names[:-1]))}.{names[-1]}"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(leaf))
    # the port's file back into JAX
    out = str(tmp_path / "port_ad.npz")
    TL.save_adapters(out, port_ad, {"rank": 2, "alpha": 4.0, "targets": "all", "model": "tiny"})
    back, meta = JL.load_adapters(out, params)
    assert meta["model"] == "tiny"
    for a, b in zip(jax.tree_util.tree_leaves(ad), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


STEP_CASES = {
    "attn": dict(lora_targets="attn"),
    "all_qat": dict(lora_targets="all", qat=True),
    "mlp_freeze_image": dict(lora_targets="mlp", freeze_image_encoder=True),
}


def lora_trainers(world, tmp, **kw):
    """The JAX and port LoRA trainers, the port's adapters set to JAX's initial ones."""
    arch, params, jpipe, tpipe, _ = world
    jcfg, tcfg = cfgs(str(tmp), lora_rank=2, lora_alpha=4.0, **kw)
    jt = JT.CLIPTrainer(JM.CLIP(arch, dtype=jnp.float32), params, jpipe, None, jcfg, rt=one_device(),
                        out_dir=str(tmp / "j"))
    tt = TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, out_dir=str(tmp / "t"))
    start, _ = to_port(tmp, jax.device_get(jt.state["params"]))
    assert set(start) == set(tt.state.adapters)
    with torch.no_grad():
        for n, a in tt.state.adapters.items():
            a.copy_(start[n])
    return jt, tt


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_lora_steps_match_jax(world, tmp_path, case):
    arch, params, _, _, batches = world
    jt, tt = lora_trainers(world, tmp_path, **STEP_CASES[case])
    base = {n: p.detach().clone() for n, p in tt.model.named_parameters()}
    state = jt.state
    for i in range(3):
        state, jm = jt.train_step(state, jt._device_batch(batches[i]))
        tt.state, tm = tt.train_step(tt.state, tt._device_batch(batches[i]))
        for key in ("loss", "loss_t2i", "loss_t2t", "grad_norm"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-4, abs=1e-4), (i, key)
    jt.state = state
    want, _ = to_port(tmp_path, jax.device_get(state["params"]))
    for n in want:
        np.testing.assert_allclose(tt.state.adapters[n].detach().numpy(), want[n].numpy(), err_msg=n, **TOL)
    assert all(torch.equal(p, base[n]) and not p.requires_grad for n, p in tt.model.named_parameters())
    if case == "mlp_freeze_image":  # frozen visual adapters: gradients, no update
        assert all(torch.equal(tt.state.adapters[n], want[n]) for n in want if n.startswith("visual."))
    got = {TL.openai_key(n): v.numpy() for n, v in tt.eval_params().items()}
    for k, v in jax_openai(jt.eval_params()).items():
        np.testing.assert_allclose(got[k].reshape(v.shape), v, err_msg=k, **TOL)


def test_lora_refusals(world, tmp_path):
    arch, params, _, tpipe, _ = world
    for kw, match in ((dict(ema_decay=0.9), "full-fine-tune"), (dict(distill_teacher="t.npz"), "mutually exclusive")):
        _, tcfg = cfgs(str(tmp_path), lora_rank=2, **kw)
        with pytest.raises(ValueError, match=match):
            TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, out_dir=str(tmp_path))


def test_lora_resume_restores_the_adapters(world, tmp_path):
    arch, params, _, tpipe, _ = world
    _, tcfg = cfgs(str(tmp_path), lora_rank=2, epochs=1)
    tt = TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, out_dir=str(tmp_path))
    tt.train()
    again = TT.CLIPTrainer(port_model(arch, params), tpipe, None, dataclasses.replace(tcfg, resume=True),
                           out_dir=str(tmp_path))
    assert again.start_epoch == 1 and again.state.step == tt.state.step
    assert all(torch.equal(again.state.adapters[n], tt.state.adapters[n]) for n in tt.state.adapters)


@pytest.fixture
def tiny_registered(world, monkeypatch):
    arch = world[0]
    monkeypatch.setitem(JM.ARCHS, "tiny-lora", arch)
    monkeypatch.setitem(TM.ARCHS, "tiny-lora", TM.CLIPArch(**dataclasses.asdict(arch)))
    return arch


def test_model_adapters_merge_at_load(world, tmp_path, tiny_registered):
    """``build_model`` with ``--model.adapters`` over a JAX-written flax
    ``.npz`` checkpoint: the parameters of JAX's ``merge_adapters``."""
    _, params, *_ = world
    base = str(tmp_path / "base.npz")
    save_params_npz(params, base)
    ad = jax_adapters(params, 5, 2, "attn", shift=0.3)
    ad_path = str(tmp_path / "ad.npz")
    JL.save_adapters(ad_path, ad, {"rank": 2, "alpha": 6.0, "targets": "attn"})
    argv = ["--model.name=tiny-lora", "--model.dtype=float32", f"--model.checkpoint={base}",
            f"--model.adapters={ad_path}"]
    want = jax_openai(JC.build_model_and_params(config_from_argv(argv))[1])
    got = openai_state_dict(TC.build_model(config_from_argv(argv), "cpu"))
    for k in want:
        np.testing.assert_array_equal(got[k].reshape(want[k].shape), want[k], err_msg=k)
    # seeded weights (no checkpoint): the port's seeded base, merged
    seeded = ["--model.name=tiny-lora", "--model.dtype=float32"]
    base_sd = openai_state_dict(TC.build_model(config_from_argv(seeded), "cpu", seed=4))
    got = openai_state_dict(TC.build_model(config_from_argv(seeded + [f"--model.adapters={ad_path}"]), "cpu", seed=4))
    want = TC.merge_adapters(ad_path, base_sd)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert not np.array_equal(got["transformer.resblocks.0.attn.in_proj_weight"],
                              base_sd["transformer.resblocks.0.attn.in_proj_weight"])
    # cli.export merges before the re-layout
    out = t_export.main([f"--model.checkpoint={base}", f"--model.adapters={ad_path}", "--format=npz",
                         f"--out={tmp_path / 'merged.npz'}"])
    merged = load_clip_state_dict(out)
    want = jax_openai(JC.merge_adapters(ad_path, jax.tree_util.tree_map(np.asarray, params)))
    for k in want:
        np.testing.assert_array_equal(merged[k].reshape(want[k].shape), want[k], err_msg=k)


def test_cli_train_lora_writes_the_best_adapters(tmp_path, tiny_registered):
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "out")
    result = t_train.main([
        "--device=cpu", "--model.name=tiny-lora", "--model.dtype=float32", "--data.dataset=synthetic:32",
        "--data.image_size=32", "--data.context_length=16", "--data.num_workers=2", "--train.batch_size=8",
        "--train.epochs=2", "--train.lr=1e-3", "--train.lora_rank=2", "--train.lora_targets=all",
        f"--train.checkpoint_dir={ckpt}", f"--eval.output_dir={out}",
    ])
    path = result["adapters_path"]
    assert path == os.path.join(out, "lora_adapters.npz") and result["epochs_run"] == 2
    got, meta = TL.load_adapters(path)
    assert meta == {"rank": 2, "alpha": 16.0, "targets": "all", "model": "tiny-lora"}
    best = TCK.load_checkpoint(ckpt, "best")[0]["params"]
    assert set(got) == set(best) and all(torch.equal(got[n], best[n]) for n in best)
    assert json.loads(open(TCK.meta_path(os.path.join(ckpt, "checkpoint_best.pt"))).read())["best_epoch"] == \
        result["best_epoch"]
    # the file loads in the JAX package over the arch's flax tree
    jparams = JM.init_params(JM.CLIP(tiny_registered, dtype=jnp.float32), jax.random.PRNGKey(0))
    jad, jmeta = JL.load_adapters(path, jparams)
    assert jmeta["rank"] == 2 and JL.lora_param_count(jad) == TL.lora_param_count(got)
