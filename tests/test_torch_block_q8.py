"""The port's per-block int8 route (B4a, B4b) held to the JAX Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode, one row tile per call so both sides
group the rows alike. The same numpy inputs go to both. The CUDA kernels are
held to these plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models import fast_encode as JF
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu.ops import fused_block as J
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import fast_encode as TF
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import load_openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as T

W, H, FF = 128, 2, 512  # default_mlp_chunks(512) == 4

# f32 activations, int8 weights: both sides run the same op order on the same
# rows, so nearly every value agrees to f32 rounding (1e-3, as
# tests/test_fast_encode.py:340). An f32 ulp from another summation order
# can still flip single int8 roundings of an activation by a whole step,
# which moves an output by about one quantization step (~2e-3 here), so a
# few values per thousand may sit up to the quant-step tolerance apart
# (0.02, tests/test_fast_encode.py:169). Never bit equality across packages.
TOL = dict(atol=1e-3, rtol=1e-3)
QUANT_STEP_ATOL, FLIPPED_SHARE = 0.02, 5e-3


def _assert_q8_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=QUANT_STEP_ATOL, rtol=0)
    off = np.abs(got - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)
    assert off.mean() <= FLIPPED_SHARE, f"{off.mean():.4%} of the values differ by more than a rounding"


def _f(v):
    return torch.tensor(np.asarray(v, np.float32))


def _attn_q8(rng, width=W):
    """(ln_scale, ln_bias, wqkv_q, wqkv_s, bqkv, wo_q, wo_s, bo) as torch tensors."""
    wqkv = T.quantize_weight(_f(rng.standard_normal((width, 3 * width)) * 0.05))
    wo = T.quantize_weight(_f(rng.standard_normal((width, width)) * 0.05))
    return (
        _f(1 + 0.1 * rng.standard_normal(width)), _f(0.1 * rng.standard_normal(width)),
        *wqkv, _f(0.02 * rng.standard_normal(3 * width)), *wo, _f(0.02 * rng.standard_normal(width)),
    )


def _mlp_q8(rng, width=W, ff=FF):
    """(ln_scale, ln_bias, w1_q, w1_s, b1, w2_q, w2_s, b2) as torch tensors."""
    w1 = T.quantize_weight(_f(rng.standard_normal((width, ff)) * 0.05))
    w2 = T.quantize_weight(_f(rng.standard_normal((ff, width)) * 0.05))
    return (
        _f(1 + 0.1 * rng.standard_normal(width)), _f(0.1 * rng.standard_normal(width)),
        *w1, _f(0.02 * rng.standard_normal(ff)), *w2, _f(0.02 * rng.standard_normal(width)),
    )


def _j(args):
    return [jnp.asarray(t.numpy()) for t in args]


_ATTN_CASES = {
    "causal": dict(causal=True, mask_len=None, s=16),
    "bidirectional": dict(causal=False, mask_len=None, s=16),
    "mask_len": dict(causal=False, mask_len=12, s=16),
    "seq32": dict(causal=True, mask_len=27, s=32),
}


@pytest.mark.parametrize("case", sorted(_ATTN_CASES))
def test_attention_block_q8_matches_pallas(rng, case):
    c = _ATTN_CASES[case]
    s = c["s"]
    x = rng.standard_normal((4 * s, W)).astype(np.float32)
    args = _attn_q8(rng)
    kw = dict(seq_len=s, heads=H, mask_len=c["mask_len"], causal=c["causal"])
    want = J.fused_attention_block_q8(jnp.asarray(x), *_j(args), **kw, tile=4 * s, interpret=True)
    got = T.fused_attention_block_q8(torch.tensor(x), *args, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _assert_q8_close(got.numpy(), want)
    plain = T.attention_block_q8_plain(
        torch.tensor(x), *args, seq_len=s, heads=H, mask_len=c["mask_len"] or s, eps=1e-5, causal=c["causal"]
    )
    assert torch.equal(got, plain)  # a CPU tensor runs the plain version


@pytest.mark.parametrize("n_chunks", [None, 2, 1])
def test_mlp_block_q8_matches_pallas(rng, n_chunks):
    x = rng.standard_normal((128, W)).astype(np.float32)
    args = _mlp_q8(rng)
    want = J.fused_mlp_block_q8(jnp.asarray(x), *_j(args), tile=128, n_chunks=n_chunks, interpret=True)
    got = T.fused_mlp_block_q8(torch.tensor(x), *args, n_chunks=n_chunks)
    _assert_q8_close(got.numpy(), want)
    assert torch.equal(got, T.mlp_block_q8_plain(torch.tensor(x), *args, n_chunks=n_chunks or 4, eps=1e-5))


def test_chunk_count_changes_the_requantization(rng):
    """The per-chunk scales are the grouping B4b must keep: another chunk
    count is another (close) result."""
    x = torch.tensor(rng.standard_normal((64, W)).astype(np.float32))
    args = _mlp_q8(rng)
    a, b = T.fused_mlp_block_q8(x, *args, n_chunks=4), T.fused_mlp_block_q8(x, *args, n_chunks=1)
    assert not torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.05)


@pytest.mark.parametrize("s,mask_len,causal", [(16, 16, True), (32, 27, False)])
def test_block_pair_is_the_whole_layer(rng, s, mask_len, causal):
    """B4b(B4a(x)) equals B1(x) exactly in the port (one body), and matches
    the JAX whole-layer kernel."""
    x = rng.standard_normal((4 * s, W)).astype(np.float32)
    a, m = _attn_q8(rng), _mlp_q8(rng)
    kw = dict(seq_len=s, heads=H, mask_len=mask_len, causal=causal)
    tx = torch.tensor(x)
    pair = T.fused_mlp_block_q8(T.fused_attention_block_q8(tx, *a, **kw), *m)
    whole = T.fused_layer_q8(tx, *a, *m, **kw)
    assert torch.equal(pair, whole)
    want = J.fused_layer_q8(jnp.asarray(x), *_j(a), *_j(m), **kw, tile=4 * s, interpret=True)
    _assert_q8_close(pair.numpy(), want)


def test_plain_route_counts_no_launch(rng):
    dispatch.reset_launch_counts()
    x = torch.tensor(rng.standard_normal((32, W)).astype(np.float32))
    T.fused_mlp_block_q8(T.fused_attention_block_q8(x, *_attn_q8(rng), seq_len=16, heads=H), *_mlp_q8(rng))
    counts = dispatch.launch_counts()
    assert counts["fused_attention_block_q8"] == 0 and counts["fused_mlp_block_q8"] == 0


def test_block_q8_shape_validation(rng):
    a, m = _attn_q8(rng), _mlp_q8(rng)
    with pytest.raises(ValueError, match="whole sequences"):
        T.fused_attention_block_q8(torch.zeros(24, W), *a, seq_len=16, heads=H)
    with pytest.raises(ValueError, match="heads"):
        T.fused_attention_block_q8(torch.zeros(32, W), *a, seq_len=16, heads=3)
    with pytest.raises(ValueError, match="x must be"):
        T.fused_mlp_block_q8(torch.zeros(32, 2 * W), *m)
    with pytest.raises(ValueError, match="chunks"):
        T.fused_mlp_block_q8(torch.zeros(32, W), *m, n_chunks=3)


# ---------------------------------------------------------------------------
# The route: an int8 layer over the cap runs B4a then B4b
# ---------------------------------------------------------------------------

ARCH = JM.CLIPArch(
    embed_dim=64, image_resolution=32, vision_layers=2, vision_width=128, vision_patch_size=8,
    context_length=32, vocab_size=512, text_width=128, text_heads=2, text_layers=2,
)


@pytest.fixture(scope="module")
def world():
    model = JM.CLIP(ARCH, dtype=jnp.float32)
    params = JM.init_params(model, jax.random.PRNGKey(2))
    tower = load_openai_state_dict(flax_to_openai(params), dtype=torch.float32, arch=ARCH)
    return model, params, tower


def _cos(a, b):
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _ids(rng, b, s):
    ids = np.zeros((b, s), np.int32)
    ids[:, 0] = ARCH.vocab_size - 2
    for i in range(b):
        n = int(rng.integers(3, s - 2))
        ids[i, 1:1 + n] = rng.integers(1, ARCH.vocab_size - 2, n)
        ids[i, 1 + n] = ARCH.vocab_size - 1
    return ids


def _record_route(monkeypatch):
    """Count the calls ``_apply_layers`` makes to each layer wrapper."""
    seen = {}
    for name in ("fused_layer_q8", "fused_attention_block_q8", "fused_mlp_block_q8"):
        real = getattr(TF, name)

        def wrapper(*a, _real=real, _name=name, **kw):
            seen[_name] = seen.get(_name, 0) + 1
            return _real(*a, **kw)

        monkeypatch.setattr(TF, name, wrapper)
    return seen


@pytest.mark.parametrize("tower_name", ["text", "image"])
def test_over_the_cap_int8_layers_run_the_block_pair(world, rng, monkeypatch, tower_name):
    model, params, tower = world
    if tower_name == "text":
        inputs = _ids(rng, 4, 16)
        jplan = JF.make_text_plan(params, dtype=jnp.float32, quantize="int8")
        plan = TF.make_text_plan(tower, dtype=torch.float32, quantize="int8")
        j_encode, t_encode, n_layers = JF.encode_text_fast, TF.encode_text_fast, ARCH.text_layers
        fp = np.asarray(JM.encode_text(model, params, jnp.asarray(inputs), normalize=False))
    else:
        inputs = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
        jplan = JF.make_vision_plan(params, dtype=jnp.float32, quantize="int8")
        plan = TF.make_vision_plan(tower, dtype=torch.float32, quantize="int8")
        j_encode, t_encode, n_layers = JF.encode_image_fast, TF.encode_image_fast, ARCH.vision_layers
        fp = np.asarray(model.apply({"params": params}, jnp.asarray(inputs), method=JM.CLIP.encode_image))

    seen = _record_route(monkeypatch)
    whole = t_encode(ARCH, plan, torch.tensor(inputs)).numpy()
    assert seen == {"fused_layer_q8": n_layers}  # under the cap: B1, as every arch in ARCHS

    seen.clear()
    monkeypatch.setattr(TF, "_LAYER_Q8_WIDE_CAP", 0)
    monkeypatch.setattr(JF, "_LAYER_Q8_WIDE_CAP", 0)
    got = t_encode(ARCH, plan, torch.tensor(inputs)).numpy()
    assert seen == {"fused_attention_block_q8": n_layers, "fused_mlp_block_q8": n_layers}
    np.testing.assert_array_equal(got, whole)  # the pair is the whole layer's arithmetic
    want = np.asarray(j_encode(ARCH, jplan, jnp.asarray(inputs), use_fused=True, interpret=True))
    np.testing.assert_allclose(got, want, **TOL)  # pooled, normalized by LN: flips wash out
    assert _cos(got, fp).min() > 0.999


def test_routing_constant_is_the_reference_rule():
    assert TF._LAYER_Q8_WIDE_CAP == JF._LAYER_Q8_WIDE_CAP == 24 * 2**20
    lp = {k: torch.zeros(shape, dtype=torch.int8) for k, shape in
          (("wqkv", (8, 24)), ("wo", (8, 8)), ("w1", (8, 32)), ("w2", (32, 8)))}
    assert TF._layer_weight_bytes(lp) == 8 * 24 + 64 + 2 * 256
