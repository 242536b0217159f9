"""The port's data-parallel train steps held to the JAX package's ``shard_map`` steps.

The JAX trainer runs over the conftest's 8 virtual devices
(``MeshRuntime.create(MeshConfig(data_parallel=8))``), the port over
``[cpu] * 8``: the batch of 16 splits into 8 shards of 2 rows, each shard's
loss is its own (local negatives) or against every shard's columns
(``global_negatives``), and gradients and metrics are the shards' mean. Both
start from one flax init (``flax_to_openai``) and take the same host
batches; per step ``loss`` / ``loss_t2i`` / ``loss_t2t`` / ``grad_norm``
agree, and so does every parameter after the steps, at rtol / atol 1e-4.
Also: GradCache, mined negatives, LoRA and distillation under the DP step,
``('dcn', 'data')`` equal to flat ``data`` (``tests/test_multislice.py``),
the batch-divisibility error, sharded ``epoch_batches`` and the sharded
``encode_dataset`` against the JAX package.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import MeshRuntime as JRuntime
from knowledge_enhanced_multimodal_retrieval_tpu.train import trainer as JT
from knowledge_enhanced_multimodal_retrieval_tpu.utils.config import MeshConfig as JMesh
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import MeshRuntime as TRuntime
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig as TMesh
from tests.test_torch_train import TOL, assert_same_params, cfgs, jax_openai, port_model, world  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread (the lane runs six workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def meshes(n=8, **kw):
    """The JAX runtime over the first ``n`` virtual devices and the port's over ``[cpu] * n``."""
    kw.setdefault("data_parallel", n // (kw.get("dcn_parallel", 1) * kw.get("model_parallel", 1)))
    return (JRuntime.create(JMesh(**kw), devices=jax.devices()[:n]),
            TRuntime.create(TMesh(**kw), [CPU] * n))


def trainers(world, tmp, jrt, trt, **kw):
    arch, params, jpipe, tpipe, _ = world
    jcfg, tcfg = cfgs(str(tmp), **kw)
    jt = JT.CLIPTrainer(JM.CLIP(arch, dtype=jnp.float32), params, jpipe, None, jcfg, rt=jrt, out_dir=str(tmp / "j"))
    tt = TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, out_dir=str(tmp / "t"), rt=trt)
    return jt, tt


def step_both(jt, tt, batches, steps=2):
    state, jm, tm = jt.state, [], []
    for i in range(steps):
        state, m = jt.train_step(state, jt._device_batch(batches[i]))
        jm.append({k: float(v) for k, v in m.items()})
        tt.state, m = tt.train_step(tt.state, tt._device_batch(batches[i]))
        tm.append({k: float(v) for k, v in m.items()})
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert set(t) == set(j), (i, sorted(t), sorted(j))
        for key in j:
            assert t[key] == pytest.approx(j[key], rel=1e-4, abs=1e-4), (i, key, t[key], j[key])
    return state, tm


DP_CASES = {
    "local": {},
    "global": dict(global_negatives=True),
    "siglip_global": dict(loss="siglip", temperature=0.1, global_negatives=True),
    "matryoshka_local": dict(matryoshka_dims=(8,)),
    "gradcache_global": dict(grad_cache_chunks=2, global_negatives=True),
    "ema_accum": dict(ema_decay=0.9, grad_accum_steps=2),
}


@pytest.mark.parametrize("case", sorted(DP_CASES))
def test_dp_steps_match_jax(world, tmp_path, case):
    jt, tt = trainers(world, tmp_path, *meshes(), **DP_CASES[case])
    state, _ = step_both(jt, tt, world[4])
    assert_same_params(openai_state_dict(tt.model), jax_openai(state["params"]))
    if "ema_decay" in DP_CASES[case]:
        got = {k[len("text."):] if k.startswith("text.") else k: v.numpy() for k, v in tt.eval_params().items()}
        assert_same_params(got, jax_openai(state["ema_params"]))


def test_local_negatives_are_the_mean_of_the_shard_losses(world, tmp_path):
    """DP with local negatives: the step's loss is the mean of each shard's
    loss computed on its own rows alone."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train.losses import joint_contrastive_loss

    _, tt = trainers(world, tmp_path, *meshes(4))
    b = tt._device_batch(world[4][0])
    with torch.no_grad():
        per = []
        for j in range(4):
            img, q, t = TT.encode_batch(tt.model, None, *(b[k].shards[j][1] for k in ("images", "query_ids",
                                                                                     "target_ids")))
            c = tt.cfg
            per.append(float(joint_contrastive_loss(img, q, t, temperature=c.temperature, t2i_weight=c.t2i_weight,
                                                    t2t_weight=c.t2t_weight)[0]))
    _, m = tt.train_step(tt.state, b)
    assert float(m["loss"]) == pytest.approx(np.mean(per), rel=1e-5)


def test_dcn_by_data_equals_flat_data(world, tmp_path):
    """``('dcn', 'data')`` 2 x 4 is the flat 8-way data axis (outer axis
    major, ``tests/test_multislice.py``), against JAX's dcn mesh too."""
    jt, tt = trainers(world, tmp_path, *meshes(8, dcn_parallel=2), global_negatives=True)
    assert tt.rt.data_axes == ("dcn", "data") and tt.rt.num_data == 8
    state, tm = step_both(jt, tt, world[4])
    _, flat = trainers(world, tmp_path / "flat", *meshes(8), global_negatives=True)
    for i in range(2):
        flat.state, m = flat.train_step(flat.state, flat._device_batch(world[4][i]))
        assert float(m["loss"]) == pytest.approx(tm[i]["loss"], rel=1e-4)
    assert_same_params(openai_state_dict(tt.model), openai_state_dict(flat.model), rtol=1e-4, atol=1e-4)


def test_mined_negatives_dp_step_matches_jax(world, tmp_path):
    from knowledge_enhanced_multimodal_retrieval_tpu.train import negatives as JN
    from tests.test_torch_negatives import mined_table

    path = str(tmp_path / "neg.npz")
    JN.save_negatives(path, *mined_table(world[2]))
    jt, tt = trainers(world, tmp_path, *meshes(), hard_negatives=path, hard_negatives_k=2, global_negatives=True)
    state, _ = step_both(jt, tt, world[4])
    assert_same_params(openai_state_dict(tt.model), jax_openai(state["params"]))


def test_lora_dp_step_matches_jax(world, tmp_path):
    from tests.test_torch_lora import to_port

    jt, tt = trainers(world, tmp_path, *meshes(), lora_rank=2, lora_alpha=4.0, lora_targets="all",
                      global_negatives=True)
    start, _ = to_port(tmp_path, jax.device_get(jt.state["params"]))
    with torch.no_grad():
        for n, a in tt.state.adapters.items():
            a.copy_(start[n])
    state, _ = step_both(jt, tt, world[4])
    want, _ = to_port(tmp_path, jax.device_get(state["params"]))
    for n in want:
        np.testing.assert_allclose(tt.state.adapters[n].detach().numpy(), want[n].numpy(), err_msg=n, **TOL)


def test_distill_dp_step_matches_jax(world, tmp_path):
    from tests.test_torch_distill import teacher_file

    path, *_ = teacher_file(world, tmp_path, 16)
    jt, tt = trainers(world, tmp_path, *meshes(), distill_teacher=path)
    state, _ = step_both(jt, tt, world[4])
    assert_same_params(openai_state_dict(tt.model), jax_openai(state["params"]))


def test_batch_must_divide_the_data_axis(world, tmp_path):
    arch, params, _, tpipe, _ = world
    _, tcfg = cfgs(str(tmp_path), batch_size=12)
    with pytest.raises(ValueError, match="divisible by the data-axis size"):
        TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, rt=meshes()[1])


@pytest.mark.parametrize("drop_last", [True, False])
def test_sharded_epoch_batches_match_jax(world, drop_last):
    _, _, jpipe, tpipe, _ = world
    for shard in range(3):
        jb = list(jpipe.epoch_batches(12, epoch=1, drop_last=drop_last, num_shards=3, shard_index=shard))
        tb = list(tpipe.epoch_batches(12, epoch=1, drop_last=drop_last, num_shards=3, shard_index=shard))
        assert [len(b.uuids) for b in tb] == [len(b.uuids) for b in jb] == [4] * 5 + ([] if drop_last else [2])
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.indices, a.indices)
            np.testing.assert_array_equal(b.query_ids, a.query_ids)
    with pytest.raises(ValueError, match="divisible"):
        next(tpipe.epoch_batches(10, num_shards=3))


@pytest.mark.parametrize("fast", [False, True])
def test_sharded_encode_dataset_matches_jax(world, fast):
    """``encode_dataset(rt=...)`` over 8 shards: 64 rows in batches of 12
    (the padded tail batch), the module towers and the fused (``fast``) ones."""
    from knowledge_enhanced_multimodal_retrieval_tpu.eval.evaluator import encode_dataset as j_encode
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval.evaluator import encode_dataset as t_encode

    arch, params, jpipe, tpipe, _ = world
    jrt, trt = meshes()
    want = j_encode(JM.CLIP(arch, dtype=jnp.float32), params, jpipe, jrt, batch_size=12, use_fast=fast)
    got = t_encode(port_model(arch, params), tpipe, batch_size=12, use_fast=fast, rt=trt)
    assert got.uuids == want.uuids
    for key in ("image", "query", "target"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), err_msg=key, **TOL)


def test_shard_params_replicates_once_a_distinct_device():
    """``shard_params`` (JAX: every device holds the whole tree): one copy a
    distinct device, the tensor itself where it already lives."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.sharding import shard_params

    rt = meshes(4)[1]
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3)}
    placed = shard_params(params, rt.mesh)
    assert list(placed) == [CPU] and all(placed[CPU][k] is v for k, v in params.items())


def test_fast_encode_step_reads_the_plans_it_is_given(world):
    """``make_encode_step(fast=True)`` takes its encode plans as ``params``,
    as the JAX step does: plans packed from other weights give those
    weights' embeddings (against the JAX step with the same plans), None
    the module's own, anything else raises."""
    from knowledge_enhanced_multimodal_retrieval_tpu.models.fast_encode import make_encode_plans as j_plans
    from knowledge_enhanced_multimodal_retrieval_tpu.parallel.sharding import host_local_batch_to_global as j_global
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fast_encode import make_encode_plans as t_plans

    arch, params, _, _, batches = world
    other = JM.init_params(JM.CLIP(arch, dtype=jnp.float32), jax.random.PRNGKey(1))
    jrt, trt = meshes(4)
    b = batches[0]
    db = j_global({"images": b.images, "query_ids": b.query_ids, "target_ids": b.target_ids}, jrt.mesh, jrt.data_axes)
    jstep = JT.make_encode_step(JM.CLIP(arch, dtype=jnp.float32), jrt, fast=True)
    want = jstep(j_plans(other, dtype=jnp.float32), db["images"], db["query_ids"], db["target_ids"])
    step = TT.make_encode_step(port_model(arch, params), trt, fast=True)
    got = step(t_plans(port_model(arch, other), dtype=torch.float32), b.images, b.query_ids, b.target_ids)
    own = step(None, b.images, b.query_ids, b.target_ids)
    mine = jstep(j_plans(params, dtype=jnp.float32), db["images"], db["query_ids"], db["target_ids"])
    for g, w, o, m in zip(got, want, own, mine):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        np.testing.assert_allclose(o.numpy(), np.asarray(m), **TOL)
        assert np.abs(np.asarray(w) - np.asarray(m)).max() > 1e-2  # the two sets of weights encode apart
    with pytest.raises(ValueError, match="encode plans"):
        step(dict(port_model(arch, other).named_parameters()), b.images, b.query_ids, b.target_ids)
