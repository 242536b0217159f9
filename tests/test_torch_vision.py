"""The port's vision tower, serving vision encoder and preprocessing held to
the JAX package.

The same seeded flax weights go to the port through ``from_flax_params``.
Two tiny archs: 32 px with patch 8 (17 tokens) and 64 px with patch 4
(257 tokens, ViT-L/14's count, padded to 272 by the serving encoder), each
width 128, 2 heads, 2 layers. The module tower is held to flax
``encode_image`` at f32; ``encode_image_fast`` to the JAX one with its
Pallas kernels in interpret mode, at ``tests/test_fast_encode.py``'s
tolerances. Preprocessing must be bit-equal to the JAX package's.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.data import datasets as JD
from knowledge_enhanced_multimodal_retrieval_tpu.data.preprocess import preprocess_pil as j_preprocess
from knowledge_enhanced_multimodal_retrieval_tpu.data.tokenizer import CLIPTokenizer as JTok
from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models import fast_encode as JF
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data import datasets as TD
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data import preprocess as TP
from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer as TTok
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import fast_encode as TF
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import arch_from_state_dict, load_openai_state_dict


def from_flax_params(params, **kw):
    """The port's CLIP from a flax parameter tree: the JAX package's
    ``flax_to_openai`` layout handed to the port's ``load_openai_state_dict``."""
    return load_openai_state_dict(flax_to_openai(params), **kw)


ARCHS = {
    "p8": JM.CLIPArch(
        embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128, vision_patch_size=8,
        context_length=77, vocab_size=49408, text_width=128, text_heads=2, text_layers=2,
    ),
    "s257": JM.CLIPArch(
        embed_dim=64, image_resolution=64, vision_layers=2, vision_width=128, vision_patch_size=4,
        context_length=77, vocab_size=49408, text_width=128, text_heads=2, text_layers=1,
    ),
}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def world(request):
    arch = ARCHS[request.param]
    model = JM.CLIP(arch, dtype=jnp.float32)
    return arch, model, JM.init_params(model, jax.random.PRNGKey(1))


def _images(rng, arch, b=3):
    r = arch.image_resolution
    return rng.standard_normal((b, r, r, 3)).astype(np.float32)


def _cos(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_vision_tower_matches_flax_f32(world, rng):
    arch, model, params = world
    imgs = _images(rng, arch)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(imgs), method=JM.CLIP.encode_image))
    tower = from_flax_params(params, dtype=torch.float32)
    assert (tower.arch.grid_size**2 + 1, tower.arch.heads_vision) == (arch.grid_size**2 + 1, 2)
    with torch.no_grad():
        got = tower.encode_image(torch.tensor(imgs)).numpy()
        direct = tower.visual(torch.tensor(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got, direct)


def test_keep_idx_is_training_only(world, rng):
    """FLIP patch subsets (a training forward): one ``keep_idx`` gives the
    flax tower's result; inference passes none and sees every patch."""
    arch, model, params = world
    tower = from_flax_params(params, dtype=torch.float32)
    imgs = _images(rng, arch, b=2)
    n_patches = arch.grid_size**2
    keep = np.stack([rng.permutation(n_patches)[: n_patches // 2] for _ in range(2)]).astype(np.int32)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(imgs), jnp.asarray(keep), method=JM.CLIP.encode_image))
    with torch.no_grad():
        got = tower.encode_image(torch.tensor(imgs), keep_idx=torch.tensor(keep)).numpy()
        every = tower.encode_image(torch.tensor(imgs), keep_idx=torch.arange(n_patches).expand(2, -1)).numpy()
        full = tower.encode_image(torch.tensor(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(every, full, atol=1e-5, rtol=1e-5)


def test_vision_plan_matches_jax_layout(world):
    arch, _, params = world
    plan = TF.make_vision_plan(from_flax_params(params, dtype=torch.float32), dtype=torch.float32)
    jplan = JF.make_vision_plan(params, dtype=jnp.float32)
    for key in ("conv_w", "class_embedding", "positional_embedding", "proj", "ln_pre_scale", "ln_post_bias"):
        np.testing.assert_array_equal(plan[key].numpy(), np.asarray(jplan[key]), err_msg=key)
    np.testing.assert_array_equal(plan["layers"][1]["w1"].numpy(), np.asarray(jplan["layers"][1]["w1"]))
    assert arch_from_state_dict(flax_to_openai(params)).image_resolution == arch.image_resolution


def test_encode_image_fast_f32_plan_matches_flax(world, rng):
    arch, model, params = world
    imgs = _images(rng, arch)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(imgs), method=JM.CLIP.encode_image))
    plan = TF.make_vision_plan(from_flax_params(params, dtype=torch.float32), dtype=torch.float32)
    got = TF.encode_image_fast(arch, plan, torch.tensor(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)  # tests/test_fast_encode.py:311


def test_encode_image_fast_bf16_plan_matches_pallas(world, rng):
    arch, _, params = world
    imgs = _images(rng, arch)
    jplan = JF.make_vision_plan(params, dtype=jnp.bfloat16)
    want = np.asarray(JF.encode_image_fast(arch, jplan, jnp.asarray(imgs), use_fused=True, interpret=True))
    plan = TF.make_vision_plan(from_flax_params(params, dtype=torch.bfloat16), dtype=torch.bfloat16)
    assert not TF.plan_is_quantized(plan)
    got = TF.encode_image_fast(arch, plan, torch.tensor(imgs)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, arch.embed_dim)
    # bf16 activations round at the same points on both sides; summation
    # order can move single values by one bf16 step (as for the text plan)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    assert _cos(got, want).min() > 0.9999


def test_encode_image_fast_int8_plan_matches_pallas(world, rng):
    arch, model, params = world
    imgs = _images(rng, arch)
    jplan = JF.make_vision_plan(params, dtype=jnp.float32, quantize="int8")
    want = np.asarray(JF.encode_image_fast(arch, jplan, jnp.asarray(imgs), use_fused=True, interpret=True))
    plan = TF.make_vision_plan(from_flax_params(params, dtype=torch.float32), dtype=torch.float32, quantize="int8")
    assert TF.plan_is_quantized(plan)
    got = TF.encode_image_fast(arch, plan, torch.tensor(imgs)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)  # tests/test_fast_encode.py:336
    fp = np.asarray(model.apply({"params": params}, jnp.asarray(imgs), method=JM.CLIP.encode_image))
    assert _cos(got, fp).min() > 0.999


def _moved(plan, fn):
    """A plan with ``fn`` applied to every tensor (a device or dtype move)."""
    if isinstance(plan, dict):
        return {k: _moved(v, fn) for k, v in plan.items()}
    if isinstance(plan, list):
        return [_moved(v, fn) for v in plan]
    return fn(plan)


def _without_k_major(plan):
    return {**plan, "layers": [{k: v for k, v in lp.items() if not k.endswith("_t")} for lp in plan["layers"]]}


def test_int8_vision_plan_keeps_k_major_copies(world, rng):
    """The vision counterpart of ``test_int8_text_plan_keeps_k_major_copies``:
    exact transposes under ``*_t``, kept by a move of the plan, changing no
    result, the encoder still at the JAX package's tolerance."""
    arch, _, params = world
    plan = TF.make_vision_plan(from_flax_params(params, dtype=torch.float32), dtype=torch.float32, quantize="int8")
    for lp in plan["layers"]:
        for name in ("wqkv", "wo", "w1", "w2"):
            wt = lp[name + "_t"]
            assert wt.dtype == torch.int8 and wt.is_contiguous() and torch.equal(wt, lp[name].t())
    moved = _moved(plan, lambda t: t.clone().cpu())
    assert all(torch.equal(a[k], b[k]) for a, b in zip(plan["layers"], moved["layers"]) for k in a)
    imgs = _images(rng, arch)
    got = TF.encode_image_fast(arch, moved, torch.tensor(imgs))
    assert torch.equal(got, TF.encode_image_fast(arch, _without_k_major(plan), torch.tensor(imgs)))
    jplan = JF.make_vision_plan(params, dtype=jnp.float32, quantize="int8")
    want = np.asarray(JF.encode_image_fast(arch, jplan, jnp.asarray(imgs), use_fused=True, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=1e-3)  # as the int8 plan test above


def test_encode_image_fast_checks_its_input(world):
    arch, _, params = world
    plan = TF.make_vision_plan(from_flax_params(params, dtype=torch.float32), dtype=torch.float32)
    r = arch.image_resolution
    with pytest.raises(ValueError, match="images must be"):
        TF.encode_image_fast(arch, plan, torch.zeros(1, r + 4, r + 4, 3))
    with pytest.raises(ValueError, match="unknown quantize"):
        TF.make_vision_plan(from_flax_params(params, dtype=torch.float32), quantize="int4")


# ---------------------------------------------------------------------------
# preprocessing and batching
# ---------------------------------------------------------------------------


def _png(arr):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["openai", "hf"])
@pytest.mark.parametrize("use_native", [None, False])
@pytest.mark.parametrize("hw", [(41, 57), (64, 33), (32, 32)])
def test_preprocess_bit_equal_to_jax(rng, mode, use_native, hw):
    from PIL import Image

    arr = (rng.random((*hw, 3)) * 255).astype(np.uint8)
    for image in (arr, Image.fromarray(arr), _png(arr), Image.fromarray(arr).convert("RGBA")):
        got = TP.preprocess_pil(image, size=24, mode=mode, use_native=use_native)
        want = j_preprocess(image, size=24, mode=mode, use_native=use_native)
        assert got.dtype == np.float32 and got.shape == (24, 24, 3)
        np.testing.assert_array_equal(got, want)


def test_rgb_array_goes_to_the_native_engine_as_it_is(rng):
    """An RGB uint8 array skips PIL's decode and conversion: the route gives
    the same bits as the PIL route, native or not."""
    from PIL import Image

    arr = (rng.random((45, 38, 3)) * 255).astype(np.uint8)
    assert np.array_equal(TP._rgb_array(arr), np.asarray(Image.fromarray(arr).convert("RGB")))
    for mode in ("openai", "hf"):
        via_pil = TP.preprocess_pil(Image.fromarray(arr), size=32, mode=mode, use_native=False)
        np.testing.assert_array_equal(TP.preprocess_pil(arr, size=32, mode=mode), via_pil)
    with pytest.raises(ValueError, match="preprocess mode"):
        TP.preprocess_pil(arr, mode="tf")


def test_safe_preprocess_falls_back_to_zeros():
    out, ok = TP.safe_preprocess(b"not an image", size=16)
    assert not ok and out.shape == (16, 16, 3) and not out.any()


def test_pipeline_batches_match_jax():
    jsrc = JD.make_synthetic_source(11, image_size=32, seed=3)
    tsrc = TD.make_synthetic_source(11, image_size=32, seed=3)
    kw = dict(image_size=32, context_length=77, num_workers=2)
    jpipe = JD.DataPipeline(jsrc, JTok([]), **kw)
    tpipe = TD.DataPipeline(tsrc, TTok([]), **kw)
    assert tpipe.num_batches(4, drop_last=False) == jpipe.num_batches(4, drop_last=False) == 3
    for shuffle in (False, True):
        jb = list(jpipe.epoch_batches(4, shuffle=shuffle, drop_last=False))
        tb = list(tpipe.epoch_batches(4, shuffle=shuffle, drop_last=False))
        assert [len(b.uuids) for b in tb] == [4, 4, 3]
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.images, a.images)
            np.testing.assert_array_equal(b.query_ids, a.query_ids)
            np.testing.assert_array_equal(b.target_ids, a.target_ids)
            np.testing.assert_array_equal(b.indices, a.indices)
            assert b.uuids == a.uuids and b.decode_ok.all()
    for shard in range(2):  # sharded: each process its half of every global batch, the tail padded
        jb = list(jpipe.epoch_batches(4, drop_last=False, num_shards=2, shard_index=shard))
        tb = list(tpipe.epoch_batches(4, drop_last=False, num_shards=2, shard_index=shard))
        assert [len(b.uuids) for b in tb] == [len(b.uuids) for b in jb] == [2, 2, 2]
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(b.indices, a.indices)
            np.testing.assert_array_equal(b.images, a.images)
