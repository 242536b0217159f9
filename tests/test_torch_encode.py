"""Port's text tower and serving encoder held to the JAX package.

The same seeded flax weights go to the port through the converter
(``from_flax_params`` = the JAX ``flax_to_openai`` layout + ``load_state_dict``).
The port's module tower is held to flax ``encode_text`` at f32; the port's
``encode_text_fast`` to the JAX one with its Pallas kernels in interpret
mode, for the bf16 and the int8 plan.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models import fast_encode as JF
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import fast_encode as TF
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import (
    from_flax_params,
    load_openai_state_dict,
    text_arch_from_state_dict,
)

# test arch: width 128, 2 heads, 2 layers, ff 512, the real CLIP vocab
ARCH = JM.CLIPArch(
    embed_dim=64, image_resolution=32, vision_layers=1, vision_width=128,
    vision_patch_size=16, context_length=32, vocab_size=49408, text_width=128,
    text_heads=2, text_layers=2,
)


@pytest.fixture(scope="module")
def flax_params():
    model = JM.CLIP(ARCH, dtype=jnp.float32)
    return model, JM.init_params(model, jax.random.PRNGKey(0))


def _ids(rng, b, s):
    ids = np.zeros((b, s), np.int32)
    ids[:, 0] = ARCH.vocab_size - 2
    for i in range(b):
        n = int(rng.integers(3, s - 2))
        ids[i, 1:1 + n] = rng.integers(1, ARCH.vocab_size - 2, n)
        ids[i, 1 + n] = ARCH.vocab_size - 1
    return ids


def _cos(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_converter_layout(flax_params):
    _, params = flax_params
    sd = flax_to_openai(params)
    # OpenAI stores in_proj_weight [3W, W]; flax's kernel is [W, 3W]
    assert sd["transformer.resblocks.0.attn.in_proj_weight"].shape == (3 * 128, 128)
    arch = text_arch_from_state_dict(sd)
    assert (arch.text_width, arch.text_layers, arch.text_heads, arch.vocab_size) == (128, 2, 2, 49408)
    tower = load_openai_state_dict(sd, dtype=torch.float32, arch=ARCH)
    np.testing.assert_array_equal(
        tower.transformer.resblocks[1].attn.in_proj_weight.detach().numpy(),
        np.asarray(params["text"]["transformer"]["resblocks_1"]["attn"]["in_proj"]["kernel"]).T,
    )


@pytest.mark.parametrize("s", [12, 16, 32])
def test_text_tower_matches_flax_f32(flax_params, rng, s):
    model, params = flax_params
    ids = _ids(rng, 6, s)
    want = np.asarray(JM.encode_text(model, params, jnp.asarray(ids), normalize=False))
    tower = from_flax_params(params, dtype=torch.float32, arch=ARCH)
    with torch.no_grad():
        got = tower(torch.tensor(ids, dtype=torch.long)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s", [12, 32])
def test_encode_fast_f32_plan_matches_flax(flax_params, rng, s):
    model, params = flax_params
    ids = _ids(rng, 5, s)
    want = np.asarray(JM.encode_text(model, params, jnp.asarray(ids), normalize=False))
    tower = from_flax_params(params, dtype=torch.float32, arch=ARCH)
    got = TF.encode_text_fast(ARCH, TF.make_text_plan(tower, dtype=torch.float32), torch.tensor(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("s", [12, 16, 32])
def test_encode_fast_bf16_plan_matches_pallas(flax_params, rng, s):
    _, params = flax_params
    ids = _ids(rng, 6, s)
    jplan = JF.make_text_plan(params, dtype=jnp.bfloat16)
    want = np.asarray(JF.encode_text_fast(ARCH, jplan, jnp.asarray(ids), use_fused=True, interpret=True))
    tower = from_flax_params(params, dtype=torch.bfloat16, arch=ARCH)
    plan = TF.make_text_plan(tower, dtype=torch.bfloat16)
    assert not TF.plan_is_quantized(plan)
    got = TF.encode_text_fast(ARCH, plan, torch.tensor(ids)).numpy()
    assert got.dtype == np.float32 and got.shape == (6, ARCH.embed_dim)
    # bf16 activations: both sides round at the same points; summation
    # order can move single values by one bf16 step (2^-8 relative)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    assert _cos(got, want).min() > 0.9999


@pytest.mark.parametrize("s", [12, 32])
def test_encode_fast_int8_plan_matches_pallas(flax_params, rng, s):
    model, params = flax_params
    ids = _ids(rng, 6, s)
    jplan = JF.make_text_plan(params, dtype=jnp.float32, quantize="int8")
    want = np.asarray(JF.encode_text_fast(ARCH, jplan, jnp.asarray(ids), use_fused=True, interpret=True))
    tower = from_flax_params(params, dtype=torch.float32, arch=ARCH)
    plan = TF.make_text_plan(tower, dtype=torch.float32, quantize="int8")
    assert TF.plan_is_quantized(plan)
    got = TF.encode_text_fast(ARCH, plan, torch.tensor(ids)).numpy()
    assert _cos(got, want).min() > 0.999  # tests/test_fast_encode.py:240
    fp = np.asarray(JM.encode_text(model, params, jnp.asarray(ids), normalize=False))
    assert _cos(got, fp).min() > 0.999


def test_make_text_plan_rejects_unknown_mode(flax_params):
    tower = from_flax_params(flax_params[1], dtype=torch.float32, arch=ARCH)
    with pytest.raises(ValueError):
        TF.make_text_plan(tower, quantize="int4")


def test_build_text_model_is_seeded():
    a = TM.build_text_model("", arch=ARCH, seed=3)
    b = TM.build_text_model("", arch=ARCH, seed=3)
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    with pytest.raises(ValueError):
        TM.build_text_model("ViT-X/99")
