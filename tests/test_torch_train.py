"""The port's train step held to the JAX trainer's, step for step.

Both packages start from one flax init (``flax_to_openai`` to the port) of a
tiny f32 arch and take the same host batches. The JAX side runs on a
one-device mesh: with ``global_negatives=False`` the JAX step computes the
loss per data shard, so only one shard is the port's whole-batch loss.
Per step ``loss``, ``loss_t2i``, ``loss_t2t`` and ``grad_norm`` agree, and
after three steps every parameter, at rtol / atol 1e-4 (the repo's fp bar).
"""

import dataclasses
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
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import MeshRuntime
from knowledge_enhanced_multimodal_retrieval_tpu.train import trainer as JT
from knowledge_enhanced_multimodal_retrieval_tpu.utils.config import MeshConfig as JMesh
from knowledge_enhanced_multimodal_retrieval_tpu.utils.config import TrainConfig as JCfg
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import DataPipeline as TPipe
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.datasets import make_synthetic_source as t_source
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_openai_state_dict, openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig as TCfg

MERGES = [("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")]
TOL = dict(rtol=1e-4, atol=1e-4)
BATCH, N = 16, 64

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread (the lane runs six workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def tiny_arch(vocab):
    """``tests/test_trainer.py``'s TINY: patch 16 on 32 px (5 tokens), width 32, 2 heads, one layer a tower."""
    return JM.CLIPArch(embed_dim=16, image_resolution=32, vision_layers=1, vision_width=32, vision_patch_size=16,
                       context_length=16, vocab_size=vocab, text_width=32, text_heads=2, text_layers=1,
                       vision_heads=2)


@pytest.fixture(scope="module")
def world():
    tok = JTok(MERGES)
    arch = tiny_arch(tok.vocab_size)
    params = JM.init_params(JM.CLIP(arch, dtype=jnp.float32), jax.random.PRNGKey(0))
    jpipe = JPipe(j_source(N, image_size=32), tok, image_size=32, context_length=16, num_workers=2)
    tpipe = TPipe(t_source(N, image_size=32), TTok(MERGES), image_size=32, context_length=16, num_workers=2)
    batches = [jpipe.make_batch(list(range(i * BATCH, (i + 1) * BATCH))) for i in range(3)]
    return arch, params, jpipe, tpipe, batches


def one_device():
    return MeshRuntime.create(JMesh(data_parallel=1), devices=jax.devices()[:1])


def port_model(arch, params, remat=False):
    return load_openai_state_dict(flax_to_openai(params), dtype=torch.float32,
                                  arch=TM.CLIPArch(**dataclasses.asdict(arch)), remat=remat)


def cfgs(tmp, **kw):
    base = dict(batch_size=BATCH, epochs=2, lr=1e-3, early_stop_patience=3, log_every=1,
                checkpoint_dir=os.path.join(tmp, "ckpt"))
    base.update(kw)
    return JCfg(**base), TCfg(**base)


def jax_openai(params):
    return {k: np.asarray(v) for k, v in flax_to_openai(jax.tree_util.tree_map(np.asarray, params)).items()}


def assert_same_params(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **(tol or TOL))


def run_both(world, tmp, steps=3, remat=False, **kw):
    """Three steps of each trainer's ``train_step`` on the same host batches:
    (per-step metrics JAX, port), (final state JAX, port trainer)."""
    arch, params, jpipe, tpipe, batches = world
    jcfg, tcfg = cfgs(str(tmp), **kw)
    jmodel = JM.CLIP(arch, dtype=jnp.float32, remat=remat)
    jt = JT.CLIPTrainer(jmodel, params, jpipe, None, jcfg, rt=one_device(), out_dir=str(tmp / "j"))
    tt = TT.CLIPTrainer(port_model(arch, params, remat), tpipe, None, tcfg, out_dir=str(tmp / "t"))
    jm, tm = [], []
    state = jt.state
    for i in range(steps):
        b = batches[i % len(batches)]
        state, m = jt.train_step(state, jt._device_batch(b))
        jm.append({k: float(v) for k, v in m.items()})
        tt.state, m = tt.train_step(tt.state, tt._device_batch(b))
        tm.append({k: float(v) for k, v in m.items()})
    return jm, tm, state, tt


STEP_CASES = {
    "default": {},
    "grad_accum": dict(grad_accum_steps=2),
    "freeze_image": dict(freeze_image_encoder=True),
    "warmup": dict(warmup_steps=3),
    "ema": dict(ema_decay=0.9),
    "siglip": dict(loss="siglip", temperature=0.1),
    "matryoshka": dict(matryoshka_dims=(8,)),
    "remat": dict(remat=True),
    "clipped": dict(grad_clip_norm=0.01),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_steps_match_jax(world, tmp_path, case):
    jm, tm, jstate, tt = run_both(world, tmp_path, **STEP_CASES[case])
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert set(t) == set(j), (i, sorted(t), sorted(j))
        for key in j:
            assert t[key] == pytest.approx(j[key], rel=1e-4, abs=1e-4), (i, key, t[key], j[key])
    assert tt.state.step == int(jstate["step"]) == 3
    assert_same_params(openai_state_dict(tt.model), jax_openai(jstate["params"]))
    if case == "ema":
        got = {k[len("text."):] if k.startswith("text.") else k: v.numpy() for k, v in tt.eval_params().items()}
        assert_same_params(got, jax_openai(jstate["ema_params"]))
    if case == "clipped":
        assert all(t["grad_norm"] > 0.01 for t in tm)  # every step clipped


def port_steps(world, tmp, steps, **kw):
    arch, params, _, tpipe, batches = world
    tt = TT.CLIPTrainer(port_model(arch, params), tpipe, None, cfgs(str(tmp), **kw)[1], out_dir=str(tmp))
    for i in range(steps):
        tt.state, _ = tt.train_step(tt.state, tt._device_batch(batches[i]))
    return tt


def test_grad_accum_updates_every_second_step(world, tmp_path):
    """MultiSteps: the first micro-step only accumulates, the second updates."""
    p0 = port_model(*world[:2])
    tt = port_steps(world, tmp_path, 1, grad_accum_steps=2)
    assert torch.equal(tt.model.text.text_projection, p0.text.text_projection)
    assert tt.state.optimizer.mini_step == 1 and tt.state.optimizer.count == 0
    tt.state, _ = tt.train_step(tt.state, tt._device_batch(world[4][1]))
    assert not torch.equal(tt.model.text.text_projection, p0.text.text_projection)
    assert tt.state.optimizer.mini_step == 0 and tt.state.optimizer.count == 1


def test_freeze_trains_only_the_projections(world, tmp_path):
    tt = port_steps(world, tmp_path, 2, freeze_image_encoder=True, freeze_text_encoder=True)
    p0 = dict(port_model(*world[:2]).named_parameters())
    moved = {n for n, p in tt.model.named_parameters() if not torch.equal(p, p0[n])}
    assert moved == {"visual.proj", "text.text_projection", "text.ln_final.weight", "text.ln_final.bias"}


def test_flip_keep_idx_matches_jax(world):
    """One ``keep_idx`` through both towers, and the port's draw: distinct
    in-range rows, ``max(1, round(P (1 - r)))`` of them, fixed by (seed, step)."""
    arch, params, *_ = world
    imgs = np.random.default_rng(1).standard_normal((4, 32, 32, 3)).astype(np.float32)
    n_patches = arch.grid_size**2
    for ratio in (0.5, 0.75, 0.99):
        keep = TT.sample_keep_idx(TT.step_generator(7, 3, "cpu"), 4, n_patches, ratio)
        assert keep.shape == (4, max(1, int(round(n_patches * (1 - ratio)))))
        assert all(len(set(r.tolist())) == keep.shape[1] for r in keep)
        assert int(keep.min()) >= 0 and int(keep.max()) < n_patches
        again = TT.sample_keep_idx(TT.step_generator(7, 3, "cpu"), 4, n_patches, ratio)
        assert torch.equal(keep, again)
    keep = TT.sample_keep_idx(TT.step_generator(0, 0, "cpu"), 4, n_patches, 0.5)
    want = JM.CLIP(arch, dtype=jnp.float32).apply({"params": params}, jnp.asarray(imgs), jnp.asarray(keep.numpy()),
                                                   method=JM.CLIP.encode_image)
    with torch.no_grad():
        got = port_model(arch, params).encode_image(torch.from_numpy(imgs), keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flip_step_matches_jax_with_one_keep_idx(world, tmp_path, monkeypatch):
    """A FLIP step (``image_mask_ratio``) given the JAX step's own subsets."""
    arch, params, jpipe, tpipe, batches = world
    jcfg, tcfg = cfgs(str(tmp_path), image_mask_ratio=0.5)
    jt = JT.CLIPTrainer(JM.CLIP(arch, dtype=jnp.float32), params, jpipe, None, jcfg, rt=one_device(),
                        out_dir=str(tmp_path / "j"))
    tt = TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, out_dir=str(tmp_path / "t"))
    drawn = []
    monkeypatch.setattr(TT, "sample_keep_idx", lambda gen, b, p, r: torch.from_numpy(drawn[-1]))
    state = jt.state
    for i in range(2):
        rng = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(jcfg.seed), i), 0)
        drawn.append(np.array(JT.sample_keep_idx(rng, BATCH, arch.grid_size**2, 0.5)))
        state, jm = jt.train_step(state, jt._device_batch(batches[i]))
        tt.state, tm = tt.train_step(tt.state, tt._device_batch(batches[i]))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-4, abs=1e-4)
    assert_same_params(openai_state_dict(tt.model), jax_openai(state["params"]))


def test_schedule_matches_jax():
    from knowledge_enhanced_multimodal_retrieval_tpu.train.schedule import cosine_annealing_lr as j_sched
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train.schedule import cosine_annealing_lr as t_sched

    for warmup in (0, 7):
        j, t = j_sched(2e-3, 4, 10, 0.1, warmup_steps=warmup), t_sched(2e-3, 4, 10, 0.1, warmup_steps=warmup)
        for step in range(0, 55):
            assert t(step) == pytest.approx(float(j(step)), rel=1e-6), (warmup, step)
    t = t_sched(1.0, 4, 10)
    assert t(0) == t(9) == pytest.approx(1.0) and t(10) < 1.0 and t(40) == t(99) == pytest.approx(0.1)


@pytest.mark.parametrize("mesh", [dict(model_parallel=2), dict(fsdp=True)])
def test_sharded_training_raises(world, tmp_path, mesh):
    """A ``mesh`` layout of tensor parallelism or FSDP trains its GSPMD step
    (over ``cpu`` repeated, as the model is on the CPU): one step equals the
    JAX package's GSPMD step over the same layout (loss 1e-5, parameters 2e-5)."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig

    arch, params, jpipe, tpipe, batches = world
    jcfg, tcfg = cfgs(str(tmp_path), global_negatives=True)
    layout = dict(data_parallel=2 if "model_parallel" in mesh else 4, **mesh)
    tt = TT.CLIPTrainer(port_model(arch, params), tpipe, None, tcfg, mesh=MeshConfig(**layout), out_dir=str(tmp_path))
    assert tt.state.layout is not None and tt.rt.mesh.size == 4
    n = tt.rt.mesh.size
    jt = JT.CLIPTrainer(JM.CLIP(arch, dtype=jnp.float32), params, jpipe, None, jcfg,
                        rt=MeshRuntime.create(JMesh(**layout), devices=jax.devices()[:n]), out_dir=str(tmp_path / "j"))
    state, jm = jt.train_step(jt.state, jt._device_batch(batches[0]))
    tt.state, tm = tt.train_step(tt.state, tt._device_batch(batches[0]))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), abs=1e-5)
    got = {k[len("text."):] if k.startswith("text.") else k: v.numpy() for k, v in tt.params().items()}
    assert_same_params(got, jax_openai(state["params"]), rtol=0, atol=2e-5)


