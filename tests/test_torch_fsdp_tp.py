"""FSDP and tensor-parallel training: the port held to the JAX package's GSPMD steps.

The specs (``parallel.fsdp``, ``parallel.tp``) are compared with the JAX
package's leaf by leaf through the layout map of ``flax_to_openai`` (the
port's weights are ``[out, in]``, flax kernels ``[in, out]``: each port
dimension carries the spec of the flax dimension it came from); the
FSDP / TP / fsdp + tp / dcn x fsdp steps against the JAX GSPMD steps over
the conftest's virtual devices and against the port's own data-parallel step
with global negatives (loss 1e-5, parameters 2e-5: ``tests/test_fsdp.py``);
the per-position state is 1/n of the replicated one; the tensor-parallel
forward against the replicated one; LoRA and distillation refuse tp / fsdp;
``CLIPTrainer`` in fsdp mode trains, and its checkpoint resumes into the
blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import fsdp as JF
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import tp as JTP
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import fsdp as TF
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import tp as TTP
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
from tests.test_torch_dp_train import meshes, one_thread, step_both, trainers  # noqa: F401
from tests.test_torch_train import assert_same_params, cfgs, jax_openai, port_model, world  # noqa: F401
from tests.torch_train_fixtures import adamw_format

ARCH2 = JM.CLIPArch(embed_dim=16, image_resolution=32, vision_layers=2, vision_width=32, vision_patch_size=16,
                    context_length=16, vocab_size=128, text_width=32, text_heads=2, text_layers=2, vision_heads=2)


def port_name(key: str) -> str:
    return key if key.startswith("visual.") or key == "logit_scale" else "text." + key


def layout_map(params):
    """Port name -> (flax path, perm): port dim i is flax dim perm[i] (found
    by sending distinct counters through ``flax_to_openai``)."""
    flat, tree = jax.tree_util.tree_flatten_with_path(params)
    base, leaves, where = 0, [], []
    for path, leaf in flat:
        shape = np.shape(leaf)
        leaves.append((np.arange(int(np.prod(shape))) + base).reshape(shape).astype(np.float64))
        where.append(("/".join(str(getattr(p, "key", p)) for p in path), base, shape))
        base += int(np.prod(shape))
    counted = jax.tree_util.tree_unflatten(tree, leaves)
    out = {}
    for key, arr in flax_to_openai(counted).items():
        arr = np.asarray(arr, np.float64)
        first = int(arr.reshape(-1)[0]) if arr.size else 0
        path, b, shape = next(w for w in where if w[1] <= first < w[1] + max(1, int(np.prod(w[2]))))
        strides = np.cumprod((list(shape[1:]) + [1])[::-1])[::-1]
        perm = []
        for i in range(arr.ndim):
            if arr.shape[i] == 1:
                perm.append(next(d for d in range(len(shape)) if shape[d] == 1 and d not in perm))
                continue
            step = int(np.take(arr, 1, axis=i).reshape(-1)[0] - arr.reshape(-1)[0])
            perm.append(next(d for d in range(len(shape)) if strides[d] == step and d not in perm))
        out[port_name(key)] = (path, tuple(perm))
    return out


def flax_specs(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", p)) for p in path): tuple(s) for path, s in flat}


def expected(jspecs, lmap, port_params):
    out = {}
    for name, p in port_params.items():
        path, perm = lmap[name]
        js = jspecs[path] + (None,) * (p.ndim - len(jspecs[path]))
        out[name] = tuple(js[perm[i]] for i in range(p.ndim))
    return out


@pytest.mark.parametrize("mode", ["fsdp", "tp", "fsdp+tp"])
def test_specs_match_jax_leaf_by_leaf(mode):
    params = JM.init_params(JM.CLIP(ARCH2, dtype=jnp.float32), jax.random.PRNGKey(0))
    model = port_model(ARCH2, params)
    named = dict(model.named_parameters())
    lmap = layout_map(params)
    assert set(lmap) == set(named)
    if mode == "tp":
        want, got = JTP.tp_param_pspecs(params), TTP.tp_param_pspecs(named)
    elif mode == "fsdp":
        want, got = JF.fsdp_param_pspecs(params, 8), TF.fsdp_param_pspecs(named, 8)
    else:
        want = JF.fsdp_param_pspecs(params, 4, base=JTP.tp_param_pspecs(params))
        got = TF.fsdp_param_pspecs(named, 4, base=TTP.tp_param_pspecs(named))
    assert got == expected(flax_specs(want), lmap, named)
    blk = "text.transformer.resblocks.0."
    if mode == "fsdp":  # the square out_proj: JAX's tie goes to flax dim 0, the port's dim 1
        assert got[blk + "attn.out_proj.weight"] == (None, "data")
    if mode == "fsdp+tp":
        assert got[blk + "mlp.c_fc.weight"] == ("model", "data")
        assert got[blk + "mlp.c_proj.weight"] == ("data", "model")
        assert got[blk + "mlp.c_fc.bias"] == ("model",)


def test_fsdp_shardings_need_the_axis():
    rt = meshes(4)[1]
    with pytest.raises(ValueError, match="no axis"):
        TF.fsdp_shardings({"w": torch.zeros(8, 8)}, rt.mesh, data_axis="expert")


def test_fsdp_state_is_one_nth_a_position(world, tmp_path):
    arch, params, _, tpipe, batches = world
    _, tcfg = cfgs(str(tmp_path), global_negatives=True)
    rt = meshes(8, fsdp=True)[1]
    tt = TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, rt=rt, out_dir=str(tmp_path))
    tt.state, _ = tt.train_step(tt.state, tt._device_batch(batches[0]))
    per = tt.state.layout.position_bytes(tt.state.optimizer.moment_tensors())
    whole = sum(p.numel() * 4 * 3 for p in port_model(arch, params).parameters())
    assert sum(per) >= whole and len(per) == 8
    assert max(per) <= 1.1 * whole / 8 + 4 * 3 * 1024 * 4, (per, whole)  # small leaves stay whole
    k = tt.state.layout.blocks["text.transformer.resblocks.0.mlp.c_fc.weight"]
    assert len(k) == 8 and all(b.shape == (128 // 8, 32) for b in k.values())


GSPMD_CASES = {
    "fsdp8": dict(data_parallel=8, fsdp=True),
    "dp2xtp2": dict(data_parallel=2, model_parallel=2),
    "fsdp4xtp2": dict(data_parallel=4, model_parallel=2, fsdp=True),
    "dcn2xfsdp4": dict(dcn_parallel=2, data_parallel=4, fsdp=True),
}


@pytest.mark.parametrize("case", sorted(GSPMD_CASES))
def test_gspmd_steps_match_jax_and_the_dp_step(world, tmp_path, case):
    """The GSPMD step against the JAX package's and against the port's DP
    step with global negatives (loss 1e-5, parameters 2e-5)."""
    from knowledge_enhanced_multimodal_retrieval_tpu.parallel import MeshRuntime as JR
    from knowledge_enhanced_multimodal_retrieval_tpu.utils.config import MeshConfig as JMesh
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import MeshRuntime as TR
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig as TMesh

    kw = GSPMD_CASES[case]
    n = kw.get("dcn_parallel", 1) * kw["data_parallel"] * kw.get("model_parallel", 1)
    jrt, trt = JR.create(JMesh(**kw), devices=jax.devices()[:n]), TR.create(TMesh(**kw), [torch.device("cpu")] * n)
    jt, tt = trainers(world, tmp_path, jrt, trt, global_negatives=True)
    assert tt.state.layout is not None
    state, tm = step_both(jt, tt, world[4], steps=1)
    got = tt.params()
    assert_same_params({n: v.numpy() for n, v in got.items()},
                       {port_name(k): v for k, v in jax_openai(state["params"]).items()}, rtol=0, atol=2e-5)
    _, dp = trainers(world, tmp_path / "dp", *meshes(8), global_negatives=True)
    dp.state, m = dp.train_step(dp.state, dp._device_batch(world[4][0]))
    assert tm[0]["loss"] == pytest.approx(float(m["loss"]), abs=1e-5)
    for name, p in dp.model.named_parameters():
        np.testing.assert_allclose(got[name].numpy(), p.detach().numpy(), rtol=0, atol=2e-5, err_msg=name)


def test_tp_forward_matches_the_replicated_one(world):
    arch, params, _, tpipe, batches = world
    rt = meshes(4, model_parallel=2)[1]
    model = port_model(arch, params)
    b = batches[0]
    with torch.no_grad():
        want = TT.encode_batch(model, None, *(torch.from_numpy(np.asarray(x)) for x in
                                              (b.images, b.query_ids, b.target_ids)))
    st = TT.init_state_gspmd(port_model(arch, params), TT.TrainConfig(), rt, 1)
    assert len(st.layout.blocks["visual.transformer.resblocks.0.attn.in_proj_weight"]) == 2
    got = TT.make_encode_step_gspmd(st.model, rt, st.layout)(None, b.images, b.query_ids, b.target_ids)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh", [dict(data_parallel=2, model_parallel=2), dict(data_parallel=4, fsdp=True)])
@pytest.mark.parametrize("variant", ["lora", "distill"])
def test_lora_and_distill_refuse_tp_and_fsdp(world, tmp_path, mesh, variant):
    from tests.test_torch_distill import teacher_file

    arch, params, _, tpipe, _ = world
    kw = dict(lora_rank=2) if variant == "lora" else dict(distill_teacher=teacher_file(world, tmp_path, 16)[0])
    _, tcfg = cfgs(str(tmp_path), **kw)
    rt = meshes(4, **mesh)[1]
    with pytest.raises(ValueError, match="plain data parallelism"):
        TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, rt=rt, out_dir=str(tmp_path))


def test_trainer_fsdp_mode_trains_and_resumes(world, tmp_path):
    """``CLIPTrainer`` over FSDP blocks: the loss falls, the state is cut,
    and a checkpoint (whole tensors) resumes into the blocks (the JAX
    ``_resume`` places the state again by mode)."""
    arch, params, _, tpipe, batches = world
    _, tcfg = cfgs(str(tmp_path), global_negatives=True, lr=1e-3, ema_decay=0.9)
    rt = meshes(8, fsdp=True)[1]
    tt = TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, rt=rt, out_dir=str(tmp_path))
    assert tt.fsdp and next(tt.model.parameters()).device.type == "meta"
    db = tt._device_batch(batches[0])
    losses = []
    for _ in range(5):
        tt.state, m = tt.train_step(tt.state, db)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    tt._save("latest", 0)
    before, ema = tt.params(), tt.eval_params()
    again = TT.CLIPTrainer(port_model(arch, params), tpipe, None, TT.TrainConfig(**{**tcfg.__dict__, "resume": True}),
                           rt=rt, out_dir=str(tmp_path / "again"))
    assert again.start_epoch == 1 and again.state.step == 5
    for name, v in again.params().items():
        torch.testing.assert_close(v, before[name], rtol=0, atol=0)
    for name, v in again.eval_params().items():
        torch.testing.assert_close(v, ema[name], rtol=0, atol=0)
    again.state, m2 = again.train_step(again.state, db)
    tt.state, m1 = tt.train_step(tt.state, db)
    assert float(m2["loss"]) == float(m1["loss"])


def test_fsdp_resumes_the_earlier_optimizer_format(world, tmp_path):
    """An optimizer state in the earlier format (torch's AdamW by index,
    written on one device) loads into the FSDP blocks: the same whole
    moments and step counts by name."""
    arch, params, _, tpipe, batches = world
    _, tcfg = cfgs(str(tmp_path), global_negatives=True, lr=1e-3)
    one = TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, out_dir=str(tmp_path / "one"))
    one.state, _ = one.train_step(one.state, one._device_batch(batches[0]))
    fs = TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, rt=meshes(8, fsdp=True)[1],
                        out_dir=str(tmp_path / "fsdp"))
    fs.state.optimizer.load_state_dict(adamw_format(one.state.optimizer))
    want, got = one.state.optimizer.state_dict(), fs.state.optimizer.state_dict()
    assert (got["count"], got["step"]) == (want["count"], want["step"])
    for key in ("exp_avg", "exp_avg_sq"):
        assert set(got[key]) == set(want[key])
        for n, v in want[key].items():
            assert torch.equal(got[key][n], v.cpu()), (key, n)
