"""The port's GradCache (``train.gradcache``) held to direct autograd and to
the JAX package's GradCache step.

``gradcache_value_and_grad`` equals autograd over the whole batch (loss and
every gradient to 1e-5); the trainer's GradCache step (``grad_cache_chunks``)
equals the JAX GradCache step for three steps, plain, with FLIP + QAT (one
``keep_idx``, chunked with the images) and with LoRA; a chunk count that
does not divide the batch raises the JAX ``ValueError``.
"""

import jax
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.train import trainer as JT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.clip import l2_normalize
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train.gradcache import gradcache_value_and_grad
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train.losses import joint_contrastive_loss
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig as TCfg
from tests.test_torch_lora import lora_trainers, to_port
from tests.test_torch_train import BATCH, TOL, assert_same_params, jax_openai, port_model, run_both, world  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread (the lane runs six workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def towers_of(model, b):
    enc_img = lambda x: l2_normalize(model.encode_image(x))  # noqa: E731
    enc_txt = lambda ids: l2_normalize(model.encode_text(ids))  # noqa: E731
    return [(enc_img, (torch.from_numpy(b.images),)), (enc_txt, (torch.from_numpy(b.query_ids),)),
            (enc_txt, (torch.from_numpy(b.target_ids),))]


def emb_loss(img_e, q_e, t_e):
    return joint_contrastive_loss(img_e, q_e, t_e, temperature=0.07)


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
def test_matches_direct_autograd(world, n_chunks):
    arch, params, _, _, batches = world
    model = port_model(arch, params)
    named = dict(model.named_parameters())
    towers = towers_of(model, batches[0])
    loss, _ = emb_loss(*(enc(*ins) for enc, ins in towers))
    loss.backward()
    want = TT.collect_grads(named)
    (got_loss, aux), got = gradcache_value_and_grad(emb_loss, towers, named, n_chunks)
    assert float(got_loss) == pytest.approx(float(loss.detach()), rel=1e-5, abs=1e-5)
    assert {"loss", "loss_t2i", "loss_t2t"} <= set(aux) and all(p.grad is None for p in named.values())
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-5, atol=1e-5, err_msg=n)


def test_indivisible_batch_raises(world):
    arch, params, _, _, batches = world
    model = port_model(arch, params)
    with pytest.raises(ValueError, match="must divide"):
        gradcache_value_and_grad(emb_loss, towers_of(model, batches[0]), dict(model.named_parameters()), 3)
    with pytest.raises(ValueError, match="n_chunks"):
        gradcache_value_and_grad(emb_loss, towers_of(model, batches[0]), dict(model.named_parameters()), 0)


def assert_metrics(jm, tm):
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert set(t) == set(j), (i, sorted(t), sorted(j))
        for key in j:
            assert t[key] == pytest.approx(j[key], rel=1e-4, abs=1e-4), (i, key, t[key], j[key])


def test_gradcache_steps_match_jax(world, tmp_path):
    jm, tm, jstate, tt = run_both(world, tmp_path, grad_cache_chunks=4)
    assert_metrics(jm, tm)
    assert_same_params(openai_state_dict(tt.model), jax_openai(jstate["params"]))


def test_gradcache_with_flip_and_qat_matches_jax(world, tmp_path, monkeypatch):
    """One ``keep_idx`` (the JAX step's own draw), chunked with the images,
    through QAT's forward. One step: QAT's roundings are discontinuous, so
    once the two packages' parameters differ by float noise (after an
    update) an activation on a rounding boundary can round the other way: on
    this data, with or without GradCache, the third step's ``grad_norm``
    differs by 1.2e-3 relative while the first agrees to 2e-7."""
    arch, *_ = world
    drawn = np.array(JT.sample_keep_idx(jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(TCfg().seed), 0), 0),
                                        BATCH, arch.grid_size**2, 0.5))
    monkeypatch.setattr(TT, "sample_keep_idx", lambda gen, b, p, r: torch.from_numpy(drawn))
    jm, tm, jstate, tt = run_both(world, tmp_path, steps=1, grad_cache_chunks=2, image_mask_ratio=0.5, qat=True)
    assert drawn.shape == (BATCH, 2)
    assert_metrics(jm, tm)
    assert_same_params(openai_state_dict(tt.model), jax_openai(jstate["params"]))


def test_gradcache_lora_step_matches_jax(world, tmp_path):
    batches = world[4]
    jt, tt = lora_trainers(world, tmp_path, lora_targets="all", grad_cache_chunks=2)
    state = jt.state
    for i in range(3):
        state, jm = jt.train_step(state, jt._device_batch(batches[i]))
        tt.state, tm = tt.train_step(tt.state, tt._device_batch(batches[i]))
        assert_metrics([{k: float(v) for k, v in jm.items()}], [{k: float(v) for k, v in tm.items()}])
    want, _ = to_port(tmp_path, jax.device_get(state["params"]))
    for n in want:
        np.testing.assert_allclose(tt.state.adapters[n].detach().numpy(), want[n].numpy(), err_msg=n, **TOL)
