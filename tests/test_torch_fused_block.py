"""Port's layer kernels (B3a, B3b, B1) held to the JAX Pallas kernels.

On the CPU the port's wrappers run their plain versions; the JAX side runs
its Pallas kernels in interpret mode. Same numpy inputs go to both. The
kernels themselves are held to these plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.ops import fused_block as J
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as T

W, H, FF = 128, 2, 512  # test arch: default_mlp_chunks(512) == 4


def _attn_w(rng, width=W):
    return dict(
        ln_scale=1 + 0.1 * rng.standard_normal(width),
        ln_bias=0.1 * rng.standard_normal(width),
        wqkv=rng.standard_normal((width, 3 * width)) * 0.05,
        bqkv=0.02 * rng.standard_normal(3 * width),
        wo=rng.standard_normal((width, width)) * 0.05,
        bo=0.02 * rng.standard_normal(width),
    )


def _mlp_w(rng, width=W, ff=FF):
    return dict(
        ln_scale=1 + 0.1 * rng.standard_normal(width),
        ln_bias=0.1 * rng.standard_normal(width),
        w1=rng.standard_normal((width, ff)) * 0.05,
        b1=0.02 * rng.standard_normal(ff),
        w2=rng.standard_normal((ff, width)) * 0.05,
        b2=0.02 * rng.standard_normal(width),
    )


_F32_KEYS = {"ln_scale", "ln_bias", "bqkv", "bo", "b1", "b2"}


def _both(wts, dtype):
    """numpy weights -> (jax dict, torch dict); matrices in ``dtype``, LN and
    biases f32 (the plan's layout)."""
    jd = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}[dtype]
    td = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    j = {k: jnp.asarray(v, jnp.float32 if k in _F32_KEYS else jd) for k, v in wts.items()}
    t = {k: torch.tensor(np.asarray(v, np.float32)).to(torch.float32 if k in _F32_KEYS else td) for k, v in wts.items()}
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# bf16 tolerance: both sides round to bf16 at the same points (qkv, p,
# attention output, block output); f32 sums in another order can move a
# value across one bf16 rounding boundary (2^-8 relative), and that step
# carries through the later products. Outputs are O(1-4), so 3e-2 absolute
# covers two such steps and still catches any wrong mask, scale or bias.
_BF16_ATOL = 3e-2

_ATTN_CASES = {
    "causal": dict(causal=True, mask_len=None, s=16),
    "bidirectional": dict(causal=False, mask_len=None, s=16),
    "mask_len": dict(causal=True, mask_len=12, s=16),
    "seq32": dict(causal=True, mask_len=27, s=32),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(_ATTN_CASES))
def test_attention_block_matches_pallas(rng, case, dtype):
    c = _ATTN_CASES[case]
    s = c["s"]
    x = rng.standard_normal((4 * s, W)).astype(np.float32)
    if c["mask_len"] is not None:
        x[np.arange(4 * s) % s >= c["mask_len"]] = 0.0  # padded tail rows, as the encoder makes
    jw, tw = _both(_attn_w(rng), dtype)
    jx = jnp.asarray(x, jw["wqkv"].dtype)
    tx = torch.tensor(x).to(tw["wqkv"].dtype)
    want = J.fused_attention_block(
        jx, **jw, seq_len=s, heads=H, mask_len=c["mask_len"], causal=c["causal"], tile=2 * s, interpret=True
    )
    got = T.fused_attention_block(tx, **tw, seq_len=s, heads=H, mask_len=c["mask_len"], causal=c["causal"])
    assert got.dtype == tx.dtype and got.shape == tx.shape
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=_BF16_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_block_matches_pallas(rng, dtype):
    x = rng.standard_normal((128, W)).astype(np.float32)
    jw, tw = _both(_mlp_w(rng), dtype)
    want = J.fused_mlp_block(jnp.asarray(x, jw["w1"].dtype), **jw, tile=32, interpret=True)
    got = T.fused_mlp_block(torch.tensor(x).to(tw["w1"].dtype), **tw)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(_np(got), _np(want), atol=_BF16_ATOL, rtol=0)


def test_quantize_weight_bit_equal(rng):
    w = (rng.standard_normal((W, 3 * W)) * 0.05).astype(np.float32)
    w[:, 5] = 0.0  # all-zero column: scale clamps to 1e-12
    jq, js = J.quantize_weight(jnp.asarray(w))
    tq, ts = T.quantize_weight(torch.tensor(w))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (1, 3 * W)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _q8_layer_inputs(rng, s):
    a, m = _attn_w(rng), _mlp_w(rng)
    q = {}
    for name in ("wqkv", "wo"):
        q[name] = T.quantize_weight(torch.tensor(a[name], dtype=torch.float32))
    for name in ("w1", "w2"):
        q[name] = T.quantize_weight(torch.tensor(m[name], dtype=torch.float32))
    f = lambda v: torch.tensor(np.asarray(v, np.float32))  # noqa: E731
    args = [
        f(a["ln_scale"]), f(a["ln_bias"]), *q["wqkv"], f(a["bqkv"]), *q["wo"], f(a["bo"]),
        f(m["ln_scale"]), f(m["ln_bias"]), *q["w1"], f(m["b1"]), *q["w2"], f(m["b2"]),
    ]
    x = rng.standard_normal((4 * s, W)).astype(np.float32)
    return x, args, a, m


@pytest.mark.parametrize("s,mask_len", [(16, 16), (32, 27)])
def test_layer_q8_matches_pallas(rng, s, mask_len):
    x, args, a, m = _q8_layer_inputs(rng, s)
    want = J.fused_layer_q8(
        jnp.asarray(x), *[jnp.asarray(t.numpy()) for t in args],
        seq_len=s, heads=H, mask_len=mask_len, tile=2 * s, interpret=True,
    )
    got = T.fused_layer_q8(torch.tensor(x), *args, seq_len=s, heads=H, mask_len=mask_len)
    # quant-step tolerance (tests/test_fast_encode.py:169): f32 ulps in a
    # different op grouping can flip single int8 roundings
    np.testing.assert_allclose(_np(got), _np(want), atol=0.02)
    # and the W8A8 layer stays close to the fp layer it quantizes
    tx = torch.tensor(x)
    fa = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in a.items()}
    fm = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in m.items()}
    fp = T.fused_mlp_block(T.fused_attention_block(tx, **fa, seq_len=s, heads=H, mask_len=mask_len), **fm)
    cos = torch.nn.functional.cosine_similarity(got.float(), fp, dim=-1)
    assert cos.min().item() > 0.999, cos.min()


def test_plain_route_counts_no_launch(rng):
    """A CPU tensor runs the plain version; only a kernel launch counts."""
    dispatch.reset_launch_counts()
    x = torch.tensor(rng.standard_normal((32, W)).astype(np.float32))
    _, tw = _both(_attn_w(rng), "float32")
    T.fused_attention_block(x, **tw, seq_len=16, heads=H)
    assert set(dispatch.launch_counts()) >= {"fused_attention_block", "fused_mlp_block", "fused_layer_q8"}
    assert all(v == 0 for v in dispatch.launch_counts().values())


def test_layer_shape_validation(rng):
    _, tw = _both(_attn_w(rng), "float32")
    with pytest.raises(ValueError):
        T.fused_attention_block(torch.zeros(24, W), **tw, seq_len=16, heads=H)  # not whole sequences
    with pytest.raises(ValueError):
        T.fused_attention_block(torch.zeros(32, W), **tw, seq_len=16, heads=3)  # heads
    with pytest.raises(ValueError):
        T.fused_mlp_block(torch.zeros(32, 2 * W), **_both(_mlp_w(rng), "float32")[1])
