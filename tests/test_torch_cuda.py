"""The port's hand-written kernels held to their plain versions on the card.

Every case needs a CUDA device and skips without one. The file imports no
JAX, so it also runs on a machine without it, without this suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.clip import CLIPArch, build_model
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fast_encode import (
    encode_image_fast,
    encode_text_fast,
    make_text_plan,
    make_vision_plan,
)
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import flash_attention as FA
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops.attention import mha, mha_plain
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as T
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import pq as PQ
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as S
from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import profile_vision_interior as PV

pytestmark = pytest.mark.cuda

W, H, FF = 128, 2, 512
# bf16 outputs of O(1-4): kernel and plain version round at the same points
# and differ only by f32 summation order, so one or two bf16 steps
_BF16_ATOL = 3e-2


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


def _t(a, dev, dtype):
    return torch.tensor(np.asarray(a, np.float32)).to(dev, dtype).contiguous()


def _attn(rng, dev, width=W, std=0.05):
    f32, bf = torch.float32, torch.bfloat16
    return dict(
        ln_scale=_t(1 + 0.1 * rng.standard_normal(width), dev, f32),
        ln_bias=_t(0.1 * rng.standard_normal(width), dev, f32),
        wqkv=_t(rng.standard_normal((width, 3 * width)) * std, dev, bf),
        bqkv=_t(0.02 * rng.standard_normal(3 * width), dev, f32),
        wo=_t(rng.standard_normal((width, width)) * std, dev, bf),
        bo=_t(0.02 * rng.standard_normal(width), dev, f32),
    )


def _mlp(rng, dev, width=W, ff=FF, std=0.05):
    f32, bf = torch.float32, torch.bfloat16
    return dict(
        ln_scale=_t(1 + 0.1 * rng.standard_normal(width), dev, f32),
        ln_bias=_t(0.1 * rng.standard_normal(width), dev, f32),
        w1=_t(rng.standard_normal((width, ff)) * std, dev, bf),
        b1=_t(0.02 * rng.standard_normal(ff), dev, f32),
        w2=_t(rng.standard_normal((ff, width)) * std, dev, bf),
        b2=_t(0.02 * rng.standard_normal(width), dev, f32),
    )


def _close(got, want, atol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize(
    "s,mask_len,causal,nseq",
    [(16, 16, True, 8), (16, 12, True, 3), (32, 27, True, 5), (16, 16, False, 4), (80, 77, True, 2),
     (272, 257, False, 2), (592, 577, False, 2)],  # ViT-L/14 and ViT-L/14@336px vision sequences
)
def test_attention_block_kernel(rng, dev, s, mask_len, causal, nseq):
    x = _t(rng.standard_normal((nseq * s, W)), dev, torch.bfloat16)
    w = _attn(rng, dev)
    kw = dict(seq_len=s, heads=H, mask_len=mask_len, causal=causal)
    before = T.fused_attention_block.launches
    got = T.fused_attention_block(x, **w, **kw)
    assert T.fused_attention_block.launches == before + 1
    _close(got, T.attention_block_plain(x, **w, **kw, eps=1e-5), _BF16_ATOL)


@pytest.mark.parametrize("rows", [48, 256])
def test_mlp_block_kernel(rng, dev, rows):
    x = _t(rng.standard_normal((rows, W)), dev, torch.bfloat16)
    w = _mlp(rng, dev)
    _close(T.fused_mlp_block(x, **w), T.mlp_block_plain(x, **w, eps=1e-5), _BF16_ATOL)


@pytest.mark.parametrize("s,mask_len,nseq", [(16, 16, 3), (32, 27, 8), (592, 577, 2)])
def test_layer_q8_kernel(rng, dev, s, mask_len, nseq):
    a, m = _attn(rng, dev), _mlp(rng, dev)
    qw = {k: T.quantize_weight(v.float()) for k, v in (("wqkv", a["wqkv"]), ("wo", a["wo"]), ("w1", m["w1"]), ("w2", m["w2"]))}
    args = (a["ln_scale"], a["ln_bias"], *qw["wqkv"], a["bqkv"], *qw["wo"], a["bo"],
            m["ln_scale"], m["ln_bias"], *qw["w1"], m["b1"], *qw["w2"], m["b2"])
    x = _t(rng.standard_normal((nseq * s, W)), dev, torch.bfloat16)
    got = T.fused_layer_q8(x, *args, seq_len=s, heads=H, mask_len=mask_len)
    want = T.layer_q8_plain(x, *args, seq_len=s, heads=H, mask_len=mask_len, n_chunks=4, eps=1e-5, causal=True)
    # one flipped int8 rounding (ulp-level LN / GEMM order) adds ~1e-3
    _close(got, want, 2 * _BF16_ATOL)


# -- the attention interior alone (wgmma + TMA route, and one warp per row) ------

# |o| < 4 (a row that sees one or two keys is nearly a v row): p rounds to
# bf16 at the same point in kernel and plain version, from f32 values that
# differ in their last bits, so at most one bf16 step (2^-6 there)
_INTERIOR_ATOL = 2.0 ** -6


def _interior_route(fn):
    """``fn()``'s result and the (wgmma, one-warp-per-row) launches it made."""
    before = T.attention_route_counts()
    out = fn()
    return out, tuple(a - b for a, b in zip(T.attention_route_counts(), before))


@pytest.mark.parametrize("subtract_max", [True, False], ids=["production", "no-max"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [1, 16, 17, 32, 43, 64, 65, 80, 272, 592])
def test_attention_interior_wgmma_route(rng, dev, s, causal, subtract_max):
    """Head dim 64: the interior on the tensor cores against the plain
    version, several sequences a launch (a foreign sequence's rows as keys,
    or a padding row stored, would show), every mask length class."""
    for mask_len in sorted({1, max(1, s - 15), s}):
        for nseq in (1, 5):
            qkv = _t(rng.standard_normal((nseq * s, 3 * W)), dev, torch.bfloat16)
            kw = dict(seq_len=s, heads=H, mask_len=mask_len, causal=causal, subtract_max=subtract_max)
            got, route = _interior_route(lambda: T.attention_interior(qkv, **kw))
            assert route == (1, 0), (route, s, mask_len, nseq)
            want = T._attention_interior(qkv, seq_len=s, mask_len=mask_len, heads=H, causal=causal,
                                         out_dtype=torch.bfloat16, subtract_max=subtract_max)
            _close(got, want, _INTERIOR_ATOL)


@pytest.mark.parametrize("subtract_max", [True, False], ids=["production", "no-max"])
@pytest.mark.parametrize("hd", [50, 32])
@pytest.mark.parametrize("s,mask_len,causal", [(16, 16, True), (43, 28, False), (80, 77, True), (272, 257, False)])
def test_attention_interior_per_row_route(rng, dev, s, mask_len, causal, hd, subtract_max):
    """Head dims other than 64 keep the one-warp-per-row kernel, by shape alone."""
    qkv = _t(rng.standard_normal((3 * s, 3 * 2 * hd)), dev, torch.bfloat16)
    kw = dict(seq_len=s, heads=2, mask_len=mask_len, causal=causal, subtract_max=subtract_max)
    got, route = _interior_route(lambda: T.attention_interior(qkv, **kw))
    assert route == (0, 1)
    want = T._attention_interior(qkv, seq_len=s, mask_len=mask_len, heads=2, causal=causal,
                                 out_dtype=torch.bfloat16, subtract_max=subtract_max)
    _close(got, want, _INTERIOR_ATOL)


@pytest.mark.parametrize("s,mask_len,causal", [(32, 27, True), (272, 257, False)])
def test_attention_interior_routes_agree_and_repeat(rng, dev, s, mask_len, causal):
    """The two routes compute one function (forced here; the rule is shape
    and alignment), an unaligned ``qkv`` takes the per-row route by itself,
    and a launch repeated gives the same bits (no atomics)."""
    qkv = _t(rng.standard_normal((4 * s, 3 * W)), dev, torch.bfloat16)
    kw = dict(seq_len=s, heads=H, mask_len=mask_len, causal=causal)
    new = T.attention_interior(qkv, **kw)
    assert torch.equal(new, T.attention_interior(qkv, **kw))
    T.force_row_attention(True)
    try:
        old, route = _interior_route(lambda: T.attention_interior(qkv, **kw))
    finally:
        T.force_row_attention(False)
    assert route == (0, 1)
    _close(new, old, _INTERIOR_ATOL)
    # the same rows at a base that is 2 bytes off a 16-byte boundary: TMA cannot take it
    shifted = torch.empty(qkv.numel() + 1, dtype=qkv.dtype, device=dev)[1:].view_as(qkv).copy_(qkv)
    got, route = _interior_route(lambda: T.attention_interior(shifted, **kw))
    assert route == (0, 1)
    assert torch.equal(got, old)


def test_attention_interior_refuses_wrong_operands(rng, dev):
    with pytest.raises(ValueError, match="dtype"):
        T.attention_interior(torch.zeros(32, 3 * W, device=dev), seq_len=16, heads=H)
    with pytest.raises(ValueError, match="whole sequences"):
        T.attention_interior(torch.zeros(33, 3 * W, device=dev, dtype=torch.bfloat16), seq_len=16, heads=H)


def _q8_layer(rng, dev):
    """The int8 layer plan of ``_attn`` + ``_mlp`` weights, keyed as
    ``make_vision_plan`` packs a layer."""
    a, m = _attn(rng, dev), _mlp(rng, dev)
    lp = dict(ln1_scale=a["ln_scale"], ln1_bias=a["ln_bias"], bqkv=a["bqkv"], bo=a["bo"],
              ln2_scale=m["ln_scale"], ln2_bias=m["ln_bias"], b1=m["b1"], b2=m["b2"])
    for name, w in (("wqkv", a["wqkv"]), ("wo", a["wo"]), ("w1", m["w1"]), ("w2", m["w2"])):
        lp[name], lp[name + "_s"] = T.quantize_weight(w.float())
    return lp


@pytest.mark.parametrize(
    "s,mask_len,causal,nseq", [(16, 16, True, 3), (32, 27, False, 8), (272, 257, False, 2), (592, 577, False, 2)]
)
def test_block_q8_kernels_and_their_pair(rng, dev, s, mask_len, causal, nseq):
    """B4a and B4b against their plain versions; B4b(B4a(x)) is B1(x) bit
    for bit (one body in the CUDA source)."""
    lp = _q8_layer(rng, dev)
    a, m = PV.attn_operands(lp), PV.mlp_operands(lp)
    x = _t(rng.standard_normal((nseq * s, W)), dev, torch.bfloat16)
    kw = dict(seq_len=s, heads=H, mask_len=mask_len, causal=causal)
    before = (T.fused_attention_block_q8.launches, T.fused_mlp_block_q8.launches)
    y, route = _interior_route(lambda: T.fused_attention_block_q8(x, *a, **kw))
    assert route == (1, 0)  # head dim 64: the pair and the whole layer share the wgmma interior
    out = T.fused_mlp_block_q8(y, *m)
    assert (T.fused_attention_block_q8.launches, T.fused_mlp_block_q8.launches) == (before[0] + 1, before[1] + 1)
    _close(y, T.attention_block_q8_plain(x, *a, **kw, eps=1e-5), 2 * _BF16_ATOL)
    _close(out, T.mlp_block_q8_plain(y, *m, n_chunks=4, eps=1e-5), 2 * _BF16_ATOL)
    whole, route = _interior_route(lambda: T.fused_layer_q8(x, *a, *m, **kw))
    assert route == (1, 0)
    torch.cuda.synchronize()
    assert torch.equal(out, whole)


@pytest.mark.parametrize("interior", [0, 1])
@pytest.mark.parametrize("s,mask_len,nseq", [(16, 13, 4), (272, 257, 2), (592, 577, 2)])
def test_attn_q8_variant_kernel(rng, dev, interior, s, mask_len, nseq):
    """S1 against its plain version; interior 0 is B4a bit for bit."""
    lp = _q8_layer(rng, dev)
    x = _t(rng.standard_normal((nseq * s, W)) * 0.5, dev, torch.bfloat16)
    kw = dict(seq_len=s, heads=H, mask_len=mask_len, causal=False)
    before = PV.attn_q8_variant.launches
    got, route = _interior_route(lambda: PV.attn_q8_variant(x, lp, interior=interior, **kw))
    assert PV.attn_q8_variant.launches == before + 1 and route == (1, 0)
    _close(got, PV.attn_q8_variant_plain(x, lp, interior=interior, **kw), 2 * _BF16_ATOL)
    if interior == 0:
        b4a, route = _interior_route(lambda: T.fused_attention_block_q8(x, *PV.attn_operands(lp), **kw))
        assert route == (1, 0) and torch.equal(got, b4a)


@pytest.mark.parametrize("gelu,requant", [(True, True), (True, False), (False, False), (False, True)])
@pytest.mark.parametrize("n_chunks", [None, 1])
def test_mlp_q8_diag_kernel(rng, dev, gelu, requant, n_chunks):
    """S2 against its plain version; gelu = requant = 1 is B4b bit for bit."""
    lp = _q8_layer(rng, dev)
    x = _t(rng.standard_normal((96, W)), dev, torch.bfloat16)
    before = PV.mlp_q8_diag.launches
    got = PV.mlp_q8_diag(x, lp, gelu=gelu, requant=requant, n_chunks=n_chunks)
    assert PV.mlp_q8_diag.launches == before + 1
    _close(got, PV.mlp_q8_diag_plain(x, lp, gelu=gelu, requant=requant, n_chunks=n_chunks), 2 * _BF16_ATOL)
    if gelu and requant:
        assert torch.equal(got, T.fused_mlp_block_q8(x, *PV.mlp_operands(lp), n_chunks=n_chunks))


def test_over_the_cap_layers_launch_the_block_pair(rng, dev, monkeypatch):
    """An int8 plan whose layers exceed the routing cap launches B4a + B4b
    once per layer and B1 never, with the same embeddings."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import fast_encode as FE

    arch = CLIPArch(embed_dim=64, image_resolution=32, vision_layers=2, vision_width=W, vision_patch_size=8,
                    context_length=16, vocab_size=512, text_width=W, text_heads=H, text_layers=2)
    model = build_model("", arch=arch, seed=0, device=dev)
    plan = make_vision_plan(model, quantize="int8")
    images = _t(rng.standard_normal((3, 32, 32, 3)), dev, torch.float32)
    whole = encode_image_fast(arch, plan, images)
    monkeypatch.setattr(FE, "_LAYER_Q8_WIDE_CAP", 0)
    dispatch.reset_launch_counts()
    pair = encode_image_fast(arch, plan, images)
    torch.cuda.synchronize()
    counts = dispatch.launch_counts()
    assert (counts["fused_attention_block_q8"], counts["fused_mlp_block_q8"], counts["fused_layer_q8"]) == (2, 2, 0)
    assert torch.equal(pair, whole)


def test_kernels_refuse_wrong_operands(rng, dev):
    x = _t(rng.standard_normal((32, W)), dev, torch.float32)  # kernels take bf16 activations
    with pytest.raises(ValueError, match="dtype"):
        T.fused_attention_block(x, **_attn(rng, dev), seq_len=16, heads=H)
    w = {k: v.cpu() for k, v in _mlp(rng, dev).items()}
    with pytest.raises(ValueError, match="expected cuda"):
        T.fused_mlp_block(x.bfloat16(), **w)


# -- the layer kernels' GEMM (wgmma + TMA route, and the WMMA route) -------------


def _q8_layer_at(rng, dev, width, ff):
    """``_q8_layer`` at another width, with the K-major copies a packed plan
    carries. The weights shrink with the width so that the outputs stay
    O(1-4), where ``_BF16_ATOL`` is one bf16 step."""
    std = 0.05 * (W / width) ** 0.5
    a, m = _attn(rng, dev, width, std), _mlp(rng, dev, width, ff, std)
    lp = dict(ln1_scale=a["ln_scale"], ln1_bias=a["ln_bias"], bqkv=a["bqkv"], bo=a["bo"],
              ln2_scale=m["ln_scale"], ln2_bias=m["ln_bias"], b1=m["b1"], b2=m["b2"])
    for name, w in (("wqkv", a["wqkv"]), ("wo", a["wo"]), ("w1", m["w1"]), ("w2", m["w2"])):
        lp[name], lp[name + "_s"] = T.quantize_weight(w.float())
        lp[name + "_t"] = T.k_major(lp[name])
    return a, m, lp


# rows = nseq * s leave a last row tile of 1 ... 127 rows; widths 256-1536;
# n_chunks 1-8; width 100 has rows of 200 / 100 bytes, which TMA cannot
# take: the WMMA route
_GEMM_SHAPES = [
    # width, heads, ff, n_chunks, s, nseq
    (256, 4, 1024, 8, 43, 3),    # 129 rows
    (384, 6, 1536, 4, 51, 5),    # 255 rows
    (768, 12, 3072, 8, 16, 12),  # 192 rows, ViT-L/14 text width
    (1024, 16, 1024, 1, 272, 1),  # one FF chunk, ViT-L/14 vision width
    (1536, 24, 1536, 3, 17, 8),  # 136 rows, the over-the-cap width
    (100, 2, 256, 2, 16, 9),     # 144 rows; no TMA
]


@pytest.mark.parametrize("width,heads,ff,n_chunks,s,nseq", _GEMM_SHAPES)
def test_layer_kernels_at_ragged_rows_and_widths(rng, dev, width, heads, ff, n_chunks, s, nseq):
    """B3a, B3b, B1, B4a, B4b, S1 and S2 against their plain versions, and
    which GEMM route the shape took."""
    a, m, lp = _q8_layer_at(rng, dev, width, ff)
    x = _t(rng.standard_normal((nseq * s, width)) * 0.5, dev, torch.bfloat16)
    kw = dict(seq_len=s, heads=heads, mask_len=s - 1, causal=False)
    before, interiors_before = T.gemm_route_counts(), T.attention_route_counts()
    _close(T.fused_attention_block(x, **a, **kw), T.attention_block_plain(x, **a, **kw, eps=1e-5), _BF16_ATOL)
    _close(T.fused_mlp_block(x, **m), T.mlp_block_plain(x, **m, eps=1e-5), _BF16_ATOL)
    ao, mo = PV.attn_operands(lp), PV.mlp_operands(lp)
    ak, mk = PV.attn_k_major(lp), PV.mlp_k_major(lp)
    whole = T.fused_layer_q8(x, *ao, *mo, **kw, n_chunks=n_chunks, **ak, **mk)
    _close(whole, T.layer_q8_plain(x, *ao, *mo, **kw, n_chunks=n_chunks, eps=1e-5), 2 * _BF16_ATOL)
    y = T.fused_attention_block_q8(x, *ao, **kw, **ak)
    _close(y, T.attention_block_q8_plain(x, *ao, **kw, eps=1e-5), 2 * _BF16_ATOL)
    out = T.fused_mlp_block_q8(y, *mo, n_chunks=n_chunks, **mk)
    _close(out, T.mlp_block_q8_plain(y, *mo, n_chunks=n_chunks, eps=1e-5), 2 * _BF16_ATOL)
    assert torch.equal(out, whole)  # B4b(B4a(x)) == B1(x)
    for interior in (0, 1):
        got = PV.attn_q8_variant(x, lp, interior=interior, **kw)
        _close(got, PV.attn_q8_variant_plain(x, lp, interior=interior, **kw), 2 * _BF16_ATOL)
        if interior == 0:
            assert torch.equal(got, y)  # S1 interior 0 == B4a
    for gelu, requant in ((True, True), (True, False), (False, False)):
        got = PV.mlp_q8_diag(y, lp, gelu=gelu, requant=requant, n_chunks=n_chunks)
        _close(got, PV.mlp_q8_diag_plain(y, lp, gelu=gelu, requant=requant, n_chunks=n_chunks), 2 * _BF16_ATOL)
        if gelu and requant:
            assert torch.equal(got, out)  # S2 gelu + requant == B4b
    wg, wmma = (after - b for after, b in zip(T.gemm_route_counts(), before))
    assert (wg, wmma) == ((0, wmma) if width % 16 else (wg, 0)) and wg + wmma > 0, (wg, wmma)
    # B3a, B1, B4a and S1 twice: five interiors, on the wgmma route at head dim 64
    interiors = tuple(after - b for after, b in zip(T.attention_route_counts(), interiors_before))
    assert interiors == ((5, 0) if width == 64 * heads else (0, 5)), interiors


@pytest.mark.parametrize("width,heads,ff,n_chunks,s,nseq", _GEMM_SHAPES[:5])
def test_int8_layer_is_bit_equal_on_both_gemm_routes(rng, dev, width, heads, ff, n_chunks, s, nseq):
    """s32 sums are exact in any order and both routes keep one epilogue
    arithmetic, so B1 gives the same bits on the wgmma route and on the WMMA
    route (forced here; the rule is shape and alignment)."""
    _, _, lp = _q8_layer_at(rng, dev, width, ff)
    x = _t(rng.standard_normal((nseq * s, width)) * 0.5, dev, torch.bfloat16)
    args = (x, *PV.attn_operands(lp), *PV.mlp_operands(lp))
    kw = dict(seq_len=s, heads=heads, mask_len=s - 1, causal=False, n_chunks=n_chunks)
    new = T.fused_layer_q8(*args, **kw)  # the copies made by the wrapper
    packed = T.fused_layer_q8(*args, **kw, **PV.attn_k_major(lp), **PV.mlp_k_major(lp))
    T.force_wmma_gemm(True)
    try:
        before = T.gemm_route_counts()
        old = T.fused_layer_q8(*args, **kw)
        assert T.gemm_route_counts()[0] == before[0]
    finally:
        T.force_wmma_gemm(False)
    torch.cuda.synchronize()
    assert torch.equal(new, old) and torch.equal(packed, old)


_GEMM_EDGES = [(128, 128, 128), (1, 8, 16), (300, 200, 208), (130, 72, 48), (257, 384, 384), (777, 512, 512),
               (64, 1000, 96), (500, 136, 1040)]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("m,n,k", _GEMM_EDGES)
def test_gemm_every_epilogue_at_ragged_edges(rng, dev, int8, m, n, k):
    """The GEMM alone: M, N and K that are no multiples of its tile, every
    epilogue of both element types, the accumulating ones over two chunks."""
    bias = _t(0.1 * rng.standard_normal(n), dev, torch.float32)
    res = _t(rng.standard_normal((m, n)), dev, torch.bfloat16)
    if int8:
        a, a2 = (torch.tensor(rng.integers(-127, 128, (m, k)), dtype=torch.int8, device=dev) for _ in range(2))
        b, b2 = (torch.tensor(rng.integers(-127, 128, (k, n)), dtype=torch.int8, device=dev) for _ in range(2))
        kw = dict(bias=bias, res=res, row_scale=_t(rng.uniform(1e-3, 2e-3, m), dev, torch.float32),
                  col_scale=_t(rng.uniform(1e-3, 2e-3, n), dev, torch.float32))
    else:
        a, a2 = (_t(rng.standard_normal((m, k)), dev, torch.bfloat16) for _ in range(2))
        # products of O(1) whatever K is: results stay under 8, where a bf16 step is 2^-5
        b, b2 = (_t(rng.standard_normal((k, n)) / np.sqrt(k), dev, torch.bfloat16) for _ in range(2))
        kw = dict(bias=bias, res=res, col_scale=_t(rng.uniform(0.5, 1.5, n), dev, torch.float32))
    before = T.gemm_route_counts()
    for epi in (T._EPI_INT8 if int8 else T._EPI_BF16):
        if epi in (T.EPI_ACC_F32, T.EPI_SCALE_ACC_F32):
            acc = T.gemm_epilogue(a, b, epi, last=False, **kw)
            want_acc = T.gemm_epilogue_plain(a, b, epi, last=False, **kw)
            _close(acc, want_acc, 1e-3)
            got = T.gemm_epilogue(a2, b2, epi, acc=acc, last=True, **kw)
            want = T.gemm_epilogue_plain(a2, b2, epi, acc=want_acc, last=True, **kw)
        else:
            got, want = T.gemm_epilogue(a, b, epi, **kw), T.gemm_epilogue_plain(a, b, epi, **kw)
        assert got.dtype == want.dtype and got.shape == (m, n)
        _close(got, want, 2 ** -5)  # |x| < 8 (residual + product + bias): one bf16 step
        if int8:  # the other route: the same bits
            T.force_wmma_gemm(True)
            try:
                if epi == T.EPI_ACC_F32:
                    old = T.gemm_epilogue(a2, b2, epi, acc=T.gemm_epilogue(a, b, epi, last=False, **kw), last=True, **kw)
                else:
                    old = T.gemm_epilogue(a, b, epi, **kw)
            finally:
                T.force_wmma_gemm(False)
            torch.cuda.synchronize()
            assert torch.equal(got, old), epi
    wg, wmma = (after - b0 for after, b0 in zip(T.gemm_route_counts(), before))
    assert wg > 0 and (wmma > 0) == int8, (wg, wmma)  # every shape here is one TMA can describe


def test_layer_kernels_refuse_wrong_k_major_copies(rng, dev):
    _, _, lp = _q8_layer_at(rng, dev, W, FF)
    x = _t(rng.standard_normal((32, W)), dev, torch.bfloat16)
    ao, mo = PV.attn_operands(lp), PV.mlp_operands(lp)
    kw = dict(seq_len=16, heads=H)
    with pytest.raises(ValueError, match="shape"):  # the [in, out] weight where its copy belongs
        T.fused_attention_block_q8(x, *ao, **kw, wqkv_qt=lp["wqkv"])
    with pytest.raises(ValueError, match="expected cuda"):
        T.fused_mlp_block_q8(x, *mo, w1_qt=lp["w1_t"].cpu())
    with pytest.raises(ValueError, match="contiguous"):
        T.fused_layer_q8(x, *ao, *mo, **kw, w2_qt=lp["w2"].t())
    with pytest.raises(ValueError, match="dtype"):
        T.fused_layer_q8(x, *ao, *mo, **kw, wo_qt=lp["wo_t"].to(torch.int16))
    with pytest.raises(ValueError, match="contiguous"):
        m = _mlp(rng, dev)
        T.fused_mlp_block(x, **{**m, "w1": m["w1"].t().contiguous().t()})  # the right shape, column-major
    with pytest.raises(ValueError, match="does not go with"):
        T.gemm_epilogue(x, x.t().contiguous(), T.EPI_ACC_F32, bias=lp["b1"][:32])


def _topk_check(got, scores, k):
    want = S.topk_plain(scores, k)
    torch.cuda.synchronize()
    gv, gi = got[0].cpu().numpy(), got[1].long().cpu().numpy()
    np.testing.assert_allclose(gv, want[0].cpu().numpy(), rtol=1e-5, atol=1e-6)
    s = scores.float().cpu().numpy()
    finite = gv > np.finfo(np.float32).min
    np.testing.assert_allclose(np.take_along_axis(s, gi, 1)[finite], gv[finite], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(gi[~finite], 0)
    return want


@pytest.mark.parametrize("mode", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("k", [1, 20, 128])
def test_topk_kernel(rng, dev, mode, k):
    n, q, d = 4321, 37, 96  # ragged last tile and query group
    norm = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    img, txt, qs = norm(rng.standard_normal((n, d))), norm(rng.standard_normal((n, d))), norm(rng.standard_normal((q, d)))
    qs[5] = np.nan
    img[900], txt[900] = img[17], txt[17]  # an exact tie: row 17 must rank first
    qs[6] = (img[17] + txt[17]) / 2
    alpha = torch.tensor(rng.uniform(0.2, 0.8, q), device=dev)
    if mode == "q8":
        iq, is_ = S.quantize_corpus_host(img)
        tq, ts = S.quantize_corpus_host(txt)
        c = (_t(iq, dev, torch.int8), _t(is_, dev, torch.float32), _t(tq, dev, torch.int8), _t(ts, dev, torch.float32))
        qd = _t(qs, dev, torch.bfloat16)
        got = S.fused_similarity_topk_q8(qd, *c, k, alpha=alpha)
        scores = S.blended_scores_q8(qd, *c, alpha)
    else:
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        c = (_t(img, dev, dt), _t(txt, dev, dt))
        qd = _t(qs, dev, dt)
        got = S.fused_similarity_topk(qd, *c, k, alpha=alpha)
        scores = S.blended_scores(qd, *c, alpha)
    _topk_check(got, scores, k)
    gi = got[1].cpu().numpy()
    assert (gi[5] == 0).all() and (got[0][5].cpu().numpy() == np.finfo(np.float32).min).all()
    if k > 1 and mode != "q8":
        assert gi[6, 0] == 17 and gi[6, 1] == 900


def _unit(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("q", [1, 3, 70, 200])
def test_topk_kernel_ties_across_strips(rng, dev, dtype, q):
    """Equal rows far apart land in different strips of the scan; they must
    come back lowest row first. Query 0 is the tied row itself."""
    n, d, k = 20000, 64, 8
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    img, txt, qs = _unit(rng.standard_normal((n, d))), _unit(rng.standard_normal((n, d))), _unit(rng.standard_normal((q, d)))
    twins = [19999, 12345, 7000, 130, 5]  # one tile apart up to the whole corpus apart
    for r in twins:
        img[r], txt[r] = img[5], txt[5]
    qs[0] = img[5]
    c = (_t(img, dev, dt), _t(txt, dev, dt))
    qd = _t(qs, dev, dt)
    before = S.similarity_topk_kernel.launches
    got = S.fused_similarity_topk(qd, *c, k, alpha=1.0)
    assert S.similarity_topk_kernel.launches == before + 1
    want = _topk_check(got, S.blended_scores(qd, *c, 1.0), k)
    assert got[1][0, :5].cpu().tolist() == sorted(twins)
    assert torch.equal(got[1].cpu(), want[1].cpu())  # random rows: no other near ties


@pytest.mark.parametrize("mode", ["bf16", "f32", "q8", "q4"])
def test_topk_kernel_fillers_nan_and_two_query_sets(rng, dev, mode):
    """Fewer than k finite scores (N < k), a NaN query, Q = 1, and
    ``queries_txt`` that differ from ``queries_img``, in every corpus mode."""
    d = 64
    dt = torch.float32 if mode == "f32" else torch.bfloat16

    def corpus(n):
        img, txt = _unit(rng.standard_normal((n, d))), _unit(rng.standard_normal((n, d)))
        if mode in ("bf16", "f32"):
            c = (_t(img, dev, dt), _t(txt, dev, dt))
            return c, S.fused_similarity_topk, S.blended_scores
        quant = S.quantize_corpus_host if mode == "q8" else S.quantize_corpus_host_q4
        (iq, is_), (tq, ts) = quant(img), quant(txt)
        c = (_t(iq, dev, torch.int8), _t(is_, dev, torch.float32), _t(tq, dev, torch.int8), _t(ts, dev, torch.float32))
        if mode == "q8":
            return c, S.fused_similarity_topk_q8, S.blended_scores_q8
        return c, S.fused_similarity_topk_q4, S.blended_scores_q4

    # N = 5 rows, k = 20 asked: the wrapper cuts k to N; one row is all NaN
    c, fused, plain = corpus(5)
    qd = _t(_unit(rng.standard_normal((3, d))), dev, dt)
    qd[1] = float("nan")
    got = fused(qd, *c, 20, alpha=0.3)
    assert got[0].shape == (3, 5)
    _topk_check(got, plain(qd, *c, 0.3), 5)
    assert (got[1][1] == 0).all() and (got[0][1] == torch.finfo(torch.float32).min).all()
    # Q = 1 and two query sets over a ragged corpus
    c, fused, plain = corpus(1000)
    for qn in (1, 3):
        qi = _t(_unit(rng.standard_normal((qn, d))), dev, dt)
        qt = _t(_unit(rng.standard_normal((qn, d))), dev, dt)
        alpha = torch.tensor(rng.uniform(0.2, 0.8, qn), device=dev)
        got = fused(qi, *c, 10, alpha=alpha, queries_txt=qt)
        want = _topk_check(got, plain(qi, *c, alpha, queries_txt=qt), 10)
        assert torch.equal(got[1].cpu(), want[1].cpu())
        one = fused(qi, *c, 10, alpha=alpha)
        assert not torch.equal(one[0], got[0])  # the text tower really saw the other queries


@pytest.mark.parametrize("d", [256, 384, 768, 1024, 100])
def test_topk_kernel_widths(rng, dev, d):
    """truncate_dim, the q4 byte width, ViT-L/14 and a wider arch; 100 takes
    the plain-load staging (rows of 200 bytes are not 16-byte aligned)."""
    n, q, k = 3000, 130, 20
    img, txt, qs = _unit(rng.standard_normal((n, d))), _unit(rng.standard_normal((n, d))), _unit(rng.standard_normal((q, d)))
    qd = _t(qs, dev, torch.bfloat16)
    alpha = torch.tensor(rng.uniform(0.2, 0.8, q), device=dev)
    c = (_t(img, dev, torch.bfloat16), _t(txt, dev, torch.bfloat16))
    _topk_check(S.fused_similarity_topk(qd, *c, k, alpha=alpha), S.blended_scores(qd, *c, alpha), k)
    (iq, is_), (tq, ts) = S.quantize_corpus_host(img), S.quantize_corpus_host(txt)
    c8 = (_t(iq, dev, torch.int8), _t(is_, dev, torch.float32), _t(tq, dev, torch.int8), _t(ts, dev, torch.float32))
    _topk_check(S.fused_similarity_topk_q8(qd, *c8, k, alpha=alpha), S.blended_scores_q8(qd, *c8, alpha), k)
    (ip, is_), (tp, ts) = S.quantize_corpus_host_q4(img), S.quantize_corpus_host_q4(txt)
    c4 = (_t(ip, dev, torch.int8), _t(is_, dev, torch.float32), _t(tp, dev, torch.int8), _t(ts, dev, torch.float32))
    _topk_check(S.fused_similarity_topk_q4(qd, *c4, k, alpha=alpha), S.blended_scores_q4(qd, *c4, alpha), k)


@pytest.mark.parametrize("qdtype", ["bf16", "f32"])
@pytest.mark.parametrize("k", [1, 20, 128])
def test_topk_q4_kernel(rng, dev, qdtype, k):
    """B2's q4 mode: odd N (ragged last tile), ragged query group, per-query
    alpha, a NaN query and zero pad rows."""
    n, q, d = 4321, 37, 96
    norm = lambda a: (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    img, txt, qs = norm(rng.standard_normal((n, d))), norm(rng.standard_normal((n, d))), norm(rng.standard_normal((q, d)))
    img[-9:] = 0.0
    txt[-9:] = 0.0
    qs[5] = np.nan
    ip, is_ = S.quantize_corpus_host_q4(img)
    tp, ts = S.quantize_corpus_host_q4(txt)
    c = (_t(ip, dev, torch.int8), _t(is_, dev, torch.float32), _t(tp, dev, torch.int8), _t(ts, dev, torch.float32))
    qd = _t(qs, dev, torch.bfloat16 if qdtype == "bf16" else torch.float32)
    alpha = torch.tensor(rng.uniform(0.2, 0.8, q), device=dev)
    before = S.similarity_topk_kernel.launches
    got = S.fused_similarity_topk_q4(qd, *c, k, alpha=alpha)
    assert S.similarity_topk_kernel.launches == before + 1
    _topk_check(got, S.blended_scores_q4(qd, *c, alpha), k)
    assert (got[1][5].cpu().numpy() == 0).all()


@pytest.mark.parametrize("m,n_k", [(8, 32), (96, 256), (12, 100)])
@pytest.mark.parametrize("k", [1, 20, 128, 129, 400, S.KERNEL_PASS_K, S.KERNEL_PASS_K + 1])
def test_pq_adc_kernel(rng, dev, m, n_k, k):
    """B5 against its plain version, bit for bit: ragged tiles and query
    group, per-query alpha, pad rows with scale 0, a NaN query, rows that tie
    exactly (the lower row first); M = 12 takes the bytewise code reads and a
    ragged subspace group; k above 512 runs in two passes."""
    n, q, ds = 3001, 21, 4
    lut_i, lut_t = (_t(rng.standard_normal((m, q, n_k)), dev, torch.bfloat16) for _ in range(2))
    lut_i[:, 3] = float("nan")
    codes_i, codes_t = (torch.tensor(rng.integers(0, n_k, (n, m)), dtype=torch.uint8, device=dev) for _ in range(2))
    scale_i, scale_t = (_t(rng.uniform(0.5, 1.5, (n, 1)), dev, torch.float32) for _ in range(2))
    scale_i[-13:] = 0.0
    scale_t[-13:] = 0.0
    for twin in (2900, 1500, 40):  # one tile apart up to the whole corpus apart
        for c, sc in ((codes_i, scale_i), (codes_t, scale_t)):
            c[twin], sc[twin] = c[7], sc[7]
    alpha = _t(rng.uniform(0.2, 0.8, (q, 1)), dev, torch.float32)
    args = (alpha, lut_i, lut_t, codes_i, scale_i, codes_t, scale_t)
    before = PQ.pq_adc_topk_kernel.launches
    got = PQ.pq_adc_topk(*args, k)
    passes = S.pass_sizes(k)[0]
    assert PQ.pq_adc_topk_kernel.launches == before + passes
    want = S.topk_plain(PQ.blended_adc_from_luts(*args), k)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0].cpu())  # the oracle's sums, bit for bit
    assert torch.equal(got[1].cpu(), want[1].cpu())
    assert (got[1][3].cpu().numpy() == 0).all()
    # the router at the serving shape: codebooks in, LUTs made on the card, every k on the kernel
    cb_i, cb_t = (_t(rng.standard_normal((m, n_k, ds)), dev, torch.float32) for _ in range(2))
    emb = _t(rng.standard_normal((q, m * ds)), dev, torch.bfloat16)
    got = PQ.pq_similarity_topk(emb, codes_i, scale_i, codes_t, scale_t, cb_i, cb_t, k, alpha=alpha)
    assert PQ.pq_adc_topk_kernel.launches == before + 2 * passes
    _topk_check(got, PQ.blended_scores_pq_adc(emb, codes_i, scale_i, codes_t, scale_t, cb_i, cb_t, alpha), k)


@pytest.mark.parametrize("mode", ["f32", "bf16", "q8", "q4"])
@pytest.mark.parametrize("k", [129, 400, S.KERNEL_PASS_K + 1])
def test_topk_kernel_large_k(rng, dev, mode, k):
    """B2 above k = 128: running lists in the candidate buffer, the pairwise
    merge, and above 512 two passes under a ceiling; a NaN query, an exact
    tie, a ragged corpus and query group; launches equal the passes."""
    n, q, d = 4321, 37, 96
    img, txt, qs = _unit(rng.standard_normal((n, d))), _unit(rng.standard_normal((n, d))), _unit(rng.standard_normal((q, d)))
    qs[5] = np.nan
    img[900], txt[900] = img[17], txt[17]
    qs[6] = (img[17] + txt[17]) / 2
    alpha = torch.tensor(rng.uniform(0.2, 0.8, q), device=dev)
    if mode in ("f32", "bf16"):
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        c, fused, plain = (_t(img, dev, dt), _t(txt, dev, dt)), S.fused_similarity_topk, S.blended_scores
        qd = _t(qs, dev, dt)
    else:
        quant = S.quantize_corpus_host if mode == "q8" else S.quantize_corpus_host_q4
        (iq, is_), (tq, ts) = quant(img), quant(txt)
        c = (_t(iq, dev, torch.int8), _t(is_, dev, torch.float32), _t(tq, dev, torch.int8), _t(ts, dev, torch.float32))
        fused, plain = (S.fused_similarity_topk_q8, S.blended_scores_q8) if mode == "q8" else (
            S.fused_similarity_topk_q4, S.blended_scores_q4)
        qd = _t(qs, dev, torch.bfloat16)
    before = S.similarity_topk_kernel.launches
    got = fused(qd, *c, k, alpha=alpha)
    assert S.similarity_topk_kernel.launches == before + S.pass_sizes(k)[0]
    assert got[0].shape == (q, k)
    _topk_check(got, plain(qd, *c, alpha), k)
    assert (got[1][5].cpu().numpy() == 0).all()
    if mode in ("f32", "bf16"):
        row = got[1][6].cpu().tolist()
        assert row.index(17) < row.index(900)


def test_capacity_kernels_refuse_wrong_operands(rng, dev):
    q = _t(rng.standard_normal((4, 64)), dev, torch.bfloat16)
    packed = torch.zeros((100, 32), dtype=torch.int8, device=dev)
    scale = torch.ones((100, 1), dtype=torch.float32, device=dev)
    a = torch.full((4, 1), 0.5, device=dev)
    with pytest.raises(ValueError, match="shape"):  # q4 rows are D/2 bytes
        S.similarity_topk_kernel(q, q, packed.repeat(1, 2), packed.repeat(1, 2), scale, scale, a, 5, q4=True)
    with pytest.raises(ValueError, match="q4 mode"):
        S.similarity_topk_kernel(q, q, q, q, None, None, a, 5, q4=True)
    lut = torch.zeros((8, 4, 256), dtype=torch.bfloat16, device=dev)
    codes = torch.zeros((100, 8), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        PQ.pq_adc_topk_kernel(a, lut.float(), lut, codes, scale, codes, scale, 5)
    with pytest.raises(ValueError, match="expected cuda"):
        PQ.pq_adc_topk_kernel(a, lut, lut, codes.cpu(), scale, codes, scale, 5)
    with pytest.raises(ValueError, match="kernel k"):  # any k up to the corpus rows runs, in passes
        PQ.pq_adc_topk_kernel(a, lut, lut, codes, scale, codes, scale, 101)
    with pytest.raises(ValueError, match="codebook size"):
        wide = torch.zeros((8, 4, 257), dtype=torch.bfloat16, device=dev)
        PQ.pq_adc_topk_kernel(a, wide, wide, codes, scale, codes, scale, 5)


def test_encode_text_fast_on_card_matches_cpu_plan(rng, dev):
    arch = CLIPArch(64, 32, 1, 128, 16, 77, 49408, W, H, 2)
    model = build_model("", arch=arch, seed=1)
    ids = np.zeros((6, 32), np.int64)
    ids[:, 0] = arch.vocab_size - 2
    for i in range(6):
        n = int(rng.integers(3, 29))
        ids[i, 1:1 + n] = rng.integers(1, arch.vocab_size - 2, n)
        ids[i, 1 + n] = arch.vocab_size - 1
    for quantize in (None, "int8"):
        cpu = encode_text_fast(arch, make_text_plan(model, quantize=quantize), torch.tensor(ids))
        dispatch.reset_launch_counts()
        plan = make_text_plan(model.to(dev), quantize=quantize)
        gpu = encode_text_fast(arch, plan, torch.tensor(ids, device=dev))
        counts = dispatch.launch_counts()
        assert counts["fused_layer_q8" if quantize else "fused_attention_block"] == arch.text_layers
        cos = torch.nn.functional.cosine_similarity(gpu.cpu(), cpu, dim=-1)
        assert cos.min().item() > 0.999, (quantize, cos)
        model = model.cpu()


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize(
    "sq,sk,d,causal",
    [(257, 257, 64, False), (577, 577, 64, False), (150, 150, 32, True), (200, 200, 128, True),
     (130, 130, 256, False), (64, 64, 64, True), (70, 300, 80, False), (300, 70, 64, True)],
)
def test_flash_attention_kernel(rng, dev, dtype, sq, sk, d, causal):
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q = _t(rng.standard_normal((2, 3, sq, d)), dev, dt)
    k, v = (_t(rng.standard_normal((2, 3, sk, d)), dev, dt) for _ in range(2))
    before = FA.flash_attention_kernel.launches
    got = FA.flash_attention(q, k, v, causal=causal)
    assert FA.flash_attention_kernel.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    # f32: an online softmax against a one-pass one, other summation order
    # (~1e-6); bf16: p rounded to bf16 against the running maximum in the
    # kernel and the final one in the plain version, outputs |o| < 2 rounded
    # once, so one or two bf16 steps
    _close(got, FA.flash_attention_plain(q, k, v, causal), 2e-5 if dtype == "f32" else 2 ** -6)


@pytest.mark.parametrize("sq,sk,d,causal", [
    (257, 257, 64, False), (577, 577, 64, False), (130, 130, 64, False), (8, 8, 64, False),  # ragged last key tile
    (64, 257, 64, False), (300, 8, 32, False), (1, 577, 128, False), (130, 70, 64, True),  # Sq != Sk
    (96, 130, 40, False), (65, 65, 36, True),  # rows of 80 / 72 bytes: 16-byte copies, then plain loads
])
def test_flash_attention_kernel_ragged_tiles(rng, dev, sq, sk, d, causal):
    """bf16 route: the last key tile stops at the 16-key group that holds the
    last key, query rows past Sq are padding that is never stored, and the
    masked columns weigh nothing (every key is real, so the sum of the weights
    over the real keys must be the whole of it). Head dim 64 takes the TMA
    staging, 32 and 40 the 16-byte copies, 36 plain loads, 128 the mma.sync
    kernel."""
    q = _t(rng.standard_normal((2, 2, sq, d)), dev, torch.bfloat16)
    k, v = (_t(rng.standard_normal((2, 2, sk, d)), dev, torch.bfloat16) for _ in range(2))
    got = FA.flash_attention(q, k, v, causal=causal)
    assert bool(torch.isfinite(got.float()).all())
    _close(got, FA.flash_attention_plain(q, k, v, causal), 2 ** -6)
    # constant values: every output is that constant whatever the weights, so
    # a padded key that leaked into the sum or the product would show
    ones = torch.ones_like(v)
    _close(FA.flash_attention(q, k, ones, causal=causal), torch.ones_like(q), 2 ** -7)


def test_mha_routes_long_sequences_to_the_kernel(rng, dev):
    """On the card every length launches the kernel (it beat ``mha_plain``
    from s = 16 up when measured there); only a head dim past the kernel's
    256 takes the plain version."""
    q = _t(rng.standard_normal((2, 4, 129, 64)), dev, torch.bfloat16).requires_grad_()
    before = FA.flash_attention_kernel.launches
    out = mha(q, q, q)
    assert FA.flash_attention_kernel.launches == before + 1
    for s in (128, 77, 16):  # the text tower's 77 tokens and shorter
        short = q[:, :, :s].detach()
        got = mha(short, short, short, causal=True)
        _close(got, mha_plain(short, short, short, causal=True), 2 ** -5)
    assert FA.flash_attention_kernel.launches == before + 4
    wide = _t(rng.standard_normal((1, 2, 40, 320)), dev, torch.bfloat16)
    _close(mha(wide, wide, wide), mha_plain(wide, wide, wide), 2 ** -5)
    assert FA.flash_attention_kernel.launches == before + 4  # head dim 320: no kernel has it
    out.float().square().sum().backward()  # backward: recompute through mha_plain
    assert q.grad is not None and torch.isfinite(q.grad.float()).all()


def test_vision_encoders_on_card_match_cpu(rng, dev):
    """ViT token count (257 -> 272) at a narrow width: the module tower goes
    through the flash kernel, the plans through B3a/B3b and B1."""
    arch = CLIPArch(64, 64, 2, W, 4, 77, 49408, W, H, 1)
    model = build_model("", arch=arch, seed=2, dtype=torch.float32)
    imgs = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ref = model.encode_image(torch.tensor(imgs))
        card = build_model("", arch=arch, seed=2, dtype=torch.bfloat16, device=dev)
        dispatch.reset_launch_counts()
        got = card.encode_image(torch.tensor(imgs, device=dev))
        assert dispatch.launch_counts()["flash_attention_kernel"] == arch.vision_layers
        cos = torch.nn.functional.cosine_similarity(got.cpu(), ref, dim=-1)
        assert cos.min().item() > 0.999, cos
        for quantize in (None, "int8"):
            cpu = encode_image_fast(arch, make_vision_plan(model, quantize=quantize), torch.tensor(imgs))
            dispatch.reset_launch_counts()
            gpu = encode_image_fast(arch, make_vision_plan(card, quantize=quantize), torch.tensor(imgs, device=dev))
            counts = dispatch.launch_counts()
            assert counts["fused_layer_q8" if quantize else "fused_attention_block"] == arch.vision_layers
            cos = torch.nn.functional.cosine_similarity(gpu.cpu(), cpu, dim=-1)
            assert cos.min().item() > 0.999, (quantize, cos)


def _masked_inputs(rng, mode, n=5000, d=256, q=16):
    norm = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)  # noqa: E731
    img = norm(rng.standard_normal((n, d))).astype(np.float32)
    txt = norm(rng.standard_normal((n, d))).astype(np.float32)
    qs = torch.tensor(rng.standard_normal((q, d)), dtype=torch.bfloat16 if mode != "exact_f32" else torch.float32)
    if mode.startswith("exact"):
        dt = torch.bfloat16 if mode == "exact_bf16" else torch.float32
        return S.masked_similarity_topk, [qs, torch.tensor(img).to(dt), torch.tensor(txt).to(dt)]
    if mode in ("q8", "q4"):
        quant = S.quantize_corpus_host if mode == "q8" else S.quantize_corpus_host_q4
        (a, sa), (b, sb) = quant(img), quant(txt)
        fn = S.masked_similarity_topk_q8 if mode == "q8" else S.masked_similarity_topk_q4
        return fn, [qs] + [torch.from_numpy(x) for x in (a, sa, b, sb)]
    cb_i, cb_t = PQ.train_pq_codebooks(img[:2000], m=32), PQ.train_pq_codebooks(txt[:2000], m=32)
    (ci, si), (ct, st) = PQ.pack_pq_host(img, cb_i), PQ.pack_pq_host(txt, cb_t)
    return PQ.masked_pq_similarity_topk, [qs] + [torch.from_numpy(x) for x in (ci, si, ct, st, cb_i, cb_t)]


@pytest.mark.parametrize("mask_kind", ["row", "per_query", "few"])
@pytest.mark.parametrize("mode", ["exact_f32", "exact_bf16", "q8", "q4", "pq"])
def test_masked_topk_on_card_matches_cpu(rng, dev, mode, mask_kind):
    """The masked top-k (plain PyTorch on every device) on CUDA tensors
    against the same function on the CPU: the same eligible rows, -1 where
    none is left, values within 1e-4 (another summation order)."""
    fn, args = _masked_inputs(rng, mode)
    n, q = args[1].shape[0], args[0].shape[0]
    mask = {"row": rng.random(n) < 0.3, "per_query": rng.random((q, n)) < 0.2,
            "few": np.isin(np.arange(n), [3, 999, 4321])}[mask_kind]
    alpha = list(np.linspace(0.1, 0.9, q))
    want_v, want_i = fn(*args, mask, k=40, alpha=alpha)
    got_v, got_i = fn(*[a.to(dev) for a in args], mask, k=40, alpha=alpha)
    assert got_i.is_cuda and got_i.dtype == torch.int32
    got_v, got_i = got_v.cpu(), got_i.cpu()
    np.testing.assert_allclose(got_v.numpy(), want_v.numpy(), atol=1e-4, rtol=1e-4)
    assert torch.equal(got_i < 0, want_i < 0)
    # every chosen row is eligible, and its CPU score is the card's value
    # (rows may trade places only within a near tie)
    all_v, all_i = fn(*args, mask, k=n, alpha=alpha)
    m = np.broadcast_to(mask, (q, n))
    for qi in range(q):
        cpu = dict(zip(all_i[qi].tolist(), all_v[qi].tolist()))
        live = got_i[qi][got_i[qi] >= 0].numpy()
        assert m[qi][live].all() and len(set(live.tolist())) == len(live)
        np.testing.assert_allclose([cpu[r] for r in live], got_v[qi][: len(live)].numpy(), atol=1e-4, rtol=1e-4)


# -- evaluation and learned fusion -------------------------------------------


@pytest.mark.parametrize("fusion_type", ["linear", "cross_attention", "gated", "simple_gated",
                                         "simple_gated_with_bias", "bilinear"])
def test_fusion_heads_on_card_match_cpu(rng, dev, fusion_type):
    """A head on the card (f32, TF32 off) scores as on the CPU, whole matrix
    and per-query candidates."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fusion_heads import FusionModel

    fm = FusionModel(fusion_type, 64)
    head = fm.init(3)
    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    q, i, t = (torch.tensor(norm(rng.standard_normal((n, 64)))) for n in (8, 40, 40))
    with torch.no_grad():
        want = fm.scores(head, q, i, t)
        got = fm.scores(head.to(dev), q.to(dev), i.to(dev), t.to(dev))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-5)
    cand = torch.tensor(np.stack([rng.permutation(40)[:12] for _ in range(8)]))
    want_c = fm.candidate_scores(head.cpu(), q, i[cand], t[cand])
    got_c = fm.candidate_scores(head.to(dev), q.to(dev), i[cand].to(dev), t[cand].to(dev))
    np.testing.assert_allclose(got_c.cpu().numpy(), want_c.numpy(), rtol=1e-4, atol=1e-5)


def test_blocked_ranks_on_card_match_cpu(rng, dev):
    """The metric stripes and the fusion stripes rank on the card as on the
    CPU, except rows whose diagonal sits within 1e-5 of a competitor."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import fusion as F
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval import metrics as M

    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    base = rng.standard_normal((3000, 96))
    q, t, i = (norm(base + s * rng.standard_normal((3000, 96))) for s in (0.8, 0.9, 1.0))
    uuids = [f"u{k}" for k in range(3000)]
    idx, mask, _ = F.build_hit_indices({f"u{k}": [f"u{(k * 13) % 3000}"] for k in range(0, 3000, 5)}, uuids, uuids)
    sim = 0.6 * (0.1 * (q @ i.T) + 0.9 * (q @ t.T))
    sim[np.arange(3000)[:, None], idx] += 0.4 * mask
    gap = np.abs(sim - np.diag(sim)[:, None])
    np.fill_diagonal(gap, np.inf)
    safe = gap.min(1) > 1e-5
    for got, want in (
        (M.diagonal_ranks_blocked(torch.tensor(q, device=dev), torch.tensor(i, device=dev), block=512),
         M.diagonal_ranks_blocked(q, i, block=512)),
        (F.weighted_fusion_ranks_blocked(*(torch.tensor(x, device=dev) for x in (q, t, i)), idx, mask,
                                         0.1, 0.9, 0.6, 0.4, block=512),
         F.weighted_fusion_ranks_blocked(q, t, i, idx, mask, 0.1, 0.9, 0.6, 0.4, block=512)),
    ):
        assert got.is_cuda
        np.testing.assert_array_equal(got.cpu().numpy()[safe], want.numpy()[safe])


@pytest.mark.parametrize("quantize_corpus", [False, "int8"])
def test_retrieval_fused_batch_launches_b2(rng, dev, quantize_corpus):
    """Fused serving fetches its stage-1 candidates through B2 (one launch a
    batch; a fetch above 128 rows too) and rescores them with the head: the
    answers equal the same retriever's on the CPU, and each score equals
    the head over the candidate's exact row."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fusion_heads import FusionModel
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore

    arch = CLIPArch(64, 32, 1, 128, 16, 77, 49408, 128, 2, 2)
    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    store = EmbeddingStore(image=norm(rng.standard_normal((2000, 64))), text=norm(rng.standard_normal((2000, 64))),
                           uuids=[f"uuid-{k:06d}" for k in range(2000)])
    tok = CLIPTokenizer([("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")])
    fm = FusionModel("bilinear", 64)
    queries = ["hello cat", "he cat hel", "cat cat ca"]
    out = {}
    for d in (dev, torch.device("cpu")):
        model = build_model("tiny", dtype=torch.float32, seed=0, device=d, arch=arch)
        # the module towers in f32 (the serving encoders take bf16 on the card)
        r = CLIPRetrieval(model, tok, store, device=d, top_k=10, quantize_corpus=quantize_corpus,
                          use_fused_encoder=False)
        head = fm.init(1, device=d)
        dispatch.reset_launch_counts()
        out[d.type] = [r.retrieval_fused_batch(queries, fm, head, top_k=k, factor=f) for k, f in ((10, 4), (50, 4))]
        if d.type == "cuda":
            assert dispatch.launch_counts()["similarity_topk_kernel"] == 2  # fetch 40, then 200 (one pass)
            q = r.encode_queries(queries).float()
    for got_b, want_b in zip(out["cuda"], out["cpu"]):
        for got, want in zip(got_b, want_b):
            np.testing.assert_allclose([x["score"] for x in got], [x["score"] for x in want], rtol=1e-4, atol=1e-5)
    row = {u: n for n, u in enumerate(store.uuids)}
    head = fm.init(1, device=dev)
    for qi, res in enumerate(out["cuda"][0]):
        rows = [row[x["uuid"]] for x in res]
        with torch.no_grad():
            want = fm.scores(head, q[qi : qi + 1], torch.tensor(store.image[rows], device=dev),
                             torch.tensor(store.text[rows], device=dev))[0].cpu().numpy()
        np.testing.assert_allclose([x["score"] for x in res], want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("rerank", [False, True], ids=["winners", "rerank"])
@pytest.mark.parametrize("alpha", [0.5, np.linspace(0.1, 0.9, 16).astype(np.float32)], ids=["scalar", "per_query"])
def test_pipelined_dispatch_never_waits_for_the_card(rng, dev, monkeypatch, alpha, rerank):
    """``retrieval_batches`` at depth 4 in steady state (the int8 encoder and
    corpus the search benchmark serves): no dispatch makes a synchronizing
    copy or a stream synchronize (the sync debug mode raises on either,
    shown first on the copies the dispatch used to make), each batch equals
    ``retrieval_batch``'s, and each finished batch counts one fetch."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils import profiling

    arch = CLIPArch(64, 32, 1, 128, 16, 77, 49408, W, H, 2)
    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    n = 5000
    store = EmbeddingStore(image=norm(rng.standard_normal((n, 64))), text=norm(rng.standard_normal((n, 64))),
                           uuids=[f"uuid-{k:06d}" for k in range(n)])
    tok = CLIPTokenizer([("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")])
    r = CLIPRetrieval(build_model("", arch=arch, seed=1), tok, store, device=dev, top_k=10, use_fused_encoder=True,
                      quantize="int8", quantize_corpus="int8", capacity_multiple=64, rerank=rerank)
    words = ["cat", "hello", "he", "ca", "hel", "cat he", "hello cat"]
    batches = [[" ".join(rng.choice(words, size=int(rng.integers(1, 8)))) for _ in range(16)] for _ in range(12)]
    want = [r.retrieval_batch(b, alpha=alpha) for b in batches]
    list(r.retrieval_batches(batches, alpha=alpha, depth=4))  # warm: the pinned blocks, the kernels' caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.as_tensor(np.ones((16, 8), np.int64)).to(dev)  # the pageable copy of the ids
        with pytest.raises(RuntimeError):
            torch.ones((16, 10), device=dev).cpu()  # the stream-wide fetch
    finally:
        torch.cuda.set_sync_debug_mode("default")

    finish = r._finish_results

    def finish_in_default_mode(*args):
        torch.cuda.set_sync_debug_mode("default")
        return finish(*args)

    def feed():  # a batch is dispatched right after it is handed over
        for b in batches:
            torch.cuda.set_sync_debug_mode("error")
            yield b

    monkeypatch.setattr(r, "_finish_results", finish_in_default_mode)
    profiling.enable()
    profiling.reset()
    try:
        got = list(r.retrieval_batches(feed(), alpha=alpha, depth=4))
        counters = profiling.snapshot()["counters"]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        profiling.enable(False)
        profiling.reset()
    assert got == want
    assert counters.get("retrieval.fetch_ready", 0) + counters.get("retrieval.fetch_waited", 0) == len(batches)


@pytest.mark.parametrize("encoder", ["flax", "fast", "int8"])
def test_checkpoint_layouts_load_alike_on_card(rng, dev, tmp_path, encoder):
    """An OpenAI ``.pt``, an HF-layout ``.pt`` and a flax ``.npz`` written by
    the port's writers from one seeded model load (``cli.common.build_model``)
    to bit-identical parameters on the card, and serve alike: equal tower
    outputs, and the card's embeddings agree with the same model on the CPU."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.cli.common import build_model as cli_build
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import convert as TC
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import config_from_argv

    arch = CLIPArch(64, 224, 2, 128, 14, 77, 600, 128, 2, 2)
    base = build_model("", dtype=torch.float32, seed=4, arch=arch)
    paths = {"openai": str(tmp_path / "o.pt"), "hf": str(tmp_path / "h.pt"), "flax": str(tmp_path / "f.npz")}
    TC.save_openai_pt(base, paths["openai"])
    TC.save_hf_pt(base, paths["hf"])
    TC.save_params_npz(base, paths["flax"])
    models = {k: cli_build(config_from_argv([f"--model.checkpoint={p}", "--model.dtype=bfloat16"]), dev)
              for k, p in paths.items()}
    want = TC.openai_state_dict(base)
    for m in models.values():
        got = TC.openai_state_dict(m)
        assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    images = torch.tensor(rng.standard_normal((4, 224, 224, 3)).astype(np.float32), device=dev)
    ids = torch.zeros((4, 16), dtype=torch.long, device=dev)
    ids[:, 0], ids[:, 1:5], ids[:, 5] = 598, torch.arange(1, 5, device=dev), 599
    outs = {}
    for k, m in models.items():
        if encoder == "flax":
            outs[k] = (m.encode_image(images), m.encode_text(ids))
        else:
            q = "int8" if encoder == "int8" else None
            outs[k] = (encode_image_fast(arch, make_vision_plan(m, quantize=q), images),
                       encode_text_fast(arch, make_text_plan(m, quantize=q), ids))
    for k in ("hf", "flax"):
        for a, b in zip(outs[k], outs["openai"]):
            assert torch.equal(a, b), (encoder, k)
    cpu = cli_build(config_from_argv([f"--model.checkpoint={paths['openai']}", "--model.dtype=bfloat16"]),
                    torch.device("cpu"))
    if encoder == "flax":
        ref = (cpu.encode_image(images.cpu()), cpu.encode_text(ids.cpu()))
    else:
        q = "int8" if encoder == "int8" else None
        ref = (encode_image_fast(arch, make_vision_plan(cpu, quantize=q), images.cpu()),
               encode_text_fast(arch, make_text_plan(cpu, quantize=q), ids.cpu()))
    for a, b in zip(outs["openai"], ref):
        cos = torch.nn.functional.cosine_similarity(a.float().cpu(), b.float(), dim=1)
        assert float(cos.min()) > 0.999, (encoder, cos)


@pytest.mark.parametrize("mode", ["single", "multi"])
def test_text_baseline_ranks_on_card_match_cpu(dev, mode):
    """``HashTextEncoder`` variants at 768 dims: the grouped ranks on the card
    equal the CPU's except queries with other artefacts' candidates within
    twice the f32 rounding bound of a 768-d dot product (9.2e-5) of their
    best (f64 products, equal ones included): those may move by as many
    ranks as there are such candidates."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.baselines import text_models as TT

    rng = np.random.default_rng(9)
    words = [f"w{i}" for i in range(60)]
    texts = [[f"artifact {i} " + " ".join(rng.choice(words, rng.integers(2, 8))) for _ in range(5)]
             if i % 7 else [f"artifact {i} same"] * 5 for i in range(500)]
    enc = TT.HashTextEncoder(768)
    emb = [torch.as_tensor(enc.encode([t[v] for t in texts])) for v in range(5)]
    roles = [0] if mode == "single" else range(5)
    for qv in roles:
        pool, groups = TT._pool(emb, qv)
        got = TT.grouped_ranks(emb[qv].to(dev) @ pool.to(dev).T, groups.to(dev)).cpu()
        want = TT.grouped_ranks(emb[qv] @ pool.T, groups)
        sim = emb[qv].double() @ pool.double().T
        own = groups[None, :] == torch.arange(len(texts))[:, None]
        best = torch.where(own, sim, -torch.inf).amax(1)
        # other artefacts' candidates within twice the f32 rounding bound of a 768-d dot product
        # (2 x 768 x 2^-24) of the best, f64 ties included, may order either way
        window = (((sim - best[:, None]).abs() < 2 * 768 * 2.0 ** -24) & ~own).sum(1)
        near = window > 0
        assert torch.equal(got[~near], want[~near]), qv
        assert ((got - want).abs() <= window).all()
    card = TT.evaluate_text_model(enc, texts, mode=mode, device=dev)
    cpu = TT.evaluate_text_model(enc, texts, mode=mode, device="cpu")
    assert card.keys() == cpu.keys()


@pytest.mark.parametrize("shape, causal", [((4, 12, 77, 64), True), ((4, 16, 257, 64), False),
                                           ((4, 16, 129, 64), False)])
def test_flash_attention_gradient_on_card_matches_cpu(rng, dev, shape, causal):
    """The training path's attention (text s = 77 causal, vision s = 257,
    FLIP s = 129): the kernel forward and the gradient recomputed through
    ``mha_plain`` on the card against the CPU's plain forward and gradient.
    Both run bf16 products with f32 accumulation in another order, so the
    gradients agree to about one bf16 step of their scale."""
    q, k, v = (0.5 * torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16) for _ in range(3))
    g = torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
    grads = {}
    for where in ("cpu", dev):
        qkv = [t.to(where).requires_grad_() for t in (q, k, v)]
        before = FA.flash_attention_kernel.launches
        out = FA.flash_attention(*qkv, causal=causal)
        assert FA.flash_attention_kernel.launches == before + (where != "cpu")
        grads[str(where)] = [x.float().cpu() for x in torch.autograd.grad(out, qkv, g.to(where))]
    for name, got, want in zip("qkv", grads[str(dev)], grads["cpu"]):
        assert bool(torch.isfinite(got).all()), name
        scale = float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2 ** -7, atol=2 ** -7 * scale, err_msg=name)


def _tiny_train(dev, remat=False, steps=2):
    """Two f32 train steps of a small arch (257 vision tokens) from seed 4."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig

    arch = CLIPArch(32, 64, 2, W, 4, 16, 600, W, H, 2, vision_heads=H)
    model = build_model("", arch=arch, seed=4, dtype=torch.float32, device=dev, remat=remat)
    cfg = TrainConfig(batch_size=4, lr=1e-3)
    state = TT.TrainState(model, TT.make_optimizer(cfg, 4, model))
    step = TT.make_train_step(model, cfg)
    rng = np.random.default_rng(6)
    ids = np.zeros((4, 16), np.int32)
    ids[:, :6] = rng.integers(1, 598, (4, 6))
    ids[:, 6] = 599
    batch = {"images": torch.tensor(rng.standard_normal((4, 64, 64, 3)).astype(np.float32)).to(dev),
             "query_ids": torch.tensor(ids).to(dev), "target_ids": torch.tensor(np.roll(ids, 1, 0)).to(dev)}
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(steps)]
    return losses, {n: p.detach().cpu() for n, p in model.named_parameters()}


def test_train_step_on_card_matches_cpu_f32(dev):
    before = FA.flash_attention_kernel.launches
    l_card, p_card = _tiny_train(dev)
    assert FA.flash_attention_kernel.launches - before == 2 * (2 + 2 * 2)  # 2 steps x (vision + 2 text) x 2 layers
    l_cpu, p_cpu = _tiny_train("cpu")
    np.testing.assert_allclose(l_card, l_cpu, rtol=1e-4)
    for n in p_cpu:
        np.testing.assert_allclose(p_card[n].numpy(), p_cpu[n].numpy(), rtol=1e-4, atol=1e-4, err_msg=n)


def test_remat_and_flip_forward_on_card(rng, dev):
    """remat recomputes each block (the kernel launches again in the
    backward) and changes nothing else; a FLIP forward on the card equals
    the CPU's with the same ``keep_idx``."""
    l_plain, p_plain = _tiny_train(dev, steps=1)
    before = FA.flash_attention_kernel.launches
    l_remat, p_remat = _tiny_train(dev, remat=True, steps=1)
    assert FA.flash_attention_kernel.launches - before == 2 * (2 + 2 * 2)  # forward + the recompute
    np.testing.assert_allclose(l_remat, l_plain, rtol=1e-6)
    for n in p_plain:
        np.testing.assert_allclose(p_remat[n].numpy(), p_plain[n].numpy(), rtol=1e-5, atol=1e-6, err_msg=n)
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT

    arch = CLIPArch(32, 64, 2, W, 4, 16, 600, W, H, 2, vision_heads=H)
    model = build_model("", arch=arch, seed=4, dtype=torch.float32)
    images = torch.tensor(rng.standard_normal((3, 64, 64, 3)).astype(np.float32))
    keep = TT.sample_keep_idx(TT.step_generator(1, 2, dev), 3, arch.grid_size**2, 0.5)
    assert keep.is_cuda and keep.shape == (3, 128)
    with torch.no_grad():
        want = model.encode_image(images, keep.cpu())
        got = model.to(dev).encode_image(images.to(dev), keep)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qat_fake_quant_on_card_matches_cpu(rng, dev, dtype):
    """QAT's roundings (division by the scale, round half to even) on the
    card equal the CPU's bit for bit, values and straight-through gradients."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import qat as Q

    w = torch.tensor(rng.standard_normal((3 * W, W)).astype(np.float32) * 0.05)
    x = torch.tensor(rng.standard_normal((4, 77, W)).astype(np.float32) * 3).to(dtype)
    x[0, 0] = 0.0
    for fn, t in ((Q.fake_quant_weight, w), (Q.fake_quant_rows, x)):
        want = fn(t)
        card = t.to(dev).requires_grad_(dtype == torch.float32)
        got = fn(card)
        assert torch.equal(got.cpu(), want), fn.__name__
        if card.requires_grad:
            got.sum().backward()
            assert torch.equal(card.grad.cpu(), torch.ones_like(t))


def _lora_model(where, adapters=None):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import lora as L

    arch = CLIPArch(32, 64, 2, W, 4, 16, 600, W, H, 2, vision_heads=H)
    model = build_model("", arch=arch, seed=4, dtype=torch.float32, device=where)
    if adapters is None:
        adapters = L.lora_init(dict(model.named_parameters()), 4, "all", torch.Generator().manual_seed(1))
        g = torch.Generator().manual_seed(2)
        adapters = {n: a if n.endswith(".a") else 0.05 * torch.randn(a.shape, generator=g) for n, a in adapters.items()}
    return model, {n: a.to(where) for n, a in adapters.items()}


def test_lora_merged_forward_on_card_matches_cpu(rng, dev):
    """The merge at the block projections' hook (``W + s (a @ b)ᵀ`` in f32)
    on the card: the forward through B6 equals the CPU's, equals the
    forward of the host-merged weights, and B6 launches every layer."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import lora as L

    images = torch.tensor(rng.standard_normal((3, 64, 64, 3)).astype(np.float32))
    ids = torch.tensor(rng.integers(1, 599, (3, 16)).astype(np.int64))
    out = {}
    for where in ("cpu", dev):
        model, ad = _lora_model(where)
        before = FA.flash_attention_kernel.launches
        with torch.no_grad(), L.lora_projections(model, ad, 2.0):
            out[str(where)] = [model.encode_image(images.to(where)).cpu(), model.encode_text(ids.to(where)).cpu()]
        assert FA.flash_attention_kernel.launches - before == (4 if where != "cpu" else 0)
        if where != "cpu":
            merged = L.lora_merge(dict(model.named_parameters()), ad, 2.0)
            visual = {k[len("visual."):]: v for k, v in merged.items() if k.startswith("visual.")}
            with torch.no_grad():
                again = torch.func.functional_call(model.visual, visual, (images.to(dev),))
            np.testing.assert_allclose(again.cpu().numpy(), out[str(dev)][0].numpy(), rtol=1e-5, atol=1e-5)
    for got, want in zip(out[str(dev)], out["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def _gradcache_step(where, steps=1):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig

    model, _ = _lora_model(where)
    cfg = TrainConfig(batch_size=4, lr=1e-3, grad_cache_chunks=2)
    state = TT.TrainState(model, TT.make_optimizer(cfg, 4, model))
    step = TT.make_train_step(model, cfg)
    rng = np.random.default_rng(6)
    ids = np.zeros((4, 16), np.int32)
    ids[:, :6] = rng.integers(1, 598, (4, 6))
    ids[:, 6] = 599
    batch = {"images": torch.tensor(rng.standard_normal((4, 64, 64, 3)).astype(np.float32)).to(where),
             "query_ids": torch.tensor(ids).to(where), "target_ids": torch.tensor(np.roll(ids, 1, 0)).to(where)}
    metrics = [step(state, batch)[1] for _ in range(steps)]
    return [{k: float(v) for k, v in m.items()} for m in metrics], {n: p.detach().cpu() for n, p in model.named_parameters()}


def test_gradcache_step_on_card_matches_cpu(dev):
    """A GradCache step (2 chunks: embeddings without autograd, the loss's
    gradient at the tables, a re-forward with ``backward(g_chunk)``) in f32
    on the card against the CPU; B6 launches in both passes."""
    before = FA.flash_attention_kernel.launches
    m_card, p_card = _gradcache_step(dev)
    assert FA.flash_attention_kernel.launches - before == 2 * 2 * (2 + 2 * 2)  # 2 passes x 2 chunks x 3 towers x 2 layers
    m_cpu, p_cpu = _gradcache_step("cpu")
    for key in m_cpu[0]:
        assert m_card[0][key] == pytest.approx(m_cpu[0][key], rel=1e-4, abs=1e-5), key
    for n in p_cpu:
        np.testing.assert_allclose(p_card[n].numpy(), p_cpu[n].numpy(), rtol=1e-4, atol=1e-4, err_msg=n)


@pytest.mark.parametrize("n, block", [(300, 64), (1000, 2048)])
def test_mine_hard_negatives_on_card_matches_cpu(dev, n, block):
    """Mining on the card: embeddings of small integers (exact products, so
    ties) come back in ``lax.top_k``'s order, value descending then row
    ascending, as on the CPU; ``torch.topk`` on the card promises no order."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train.negatives import mine_hard_negatives

    g = np.random.default_rng(n)
    a, c = (g.integers(-2, 3, (n, 8)).astype(np.float32) for _ in range(2))
    for k in (1, 16, 100):
        want = mine_hard_negatives(a, c, k, block=block)
        got = mine_hard_negatives(torch.from_numpy(a).to(dev), torch.from_numpy(c).to(dev), k, block=block)
        np.testing.assert_array_equal(got, want)
    scores = a @ c.T
    np.fill_diagonal(scores, -np.inf)
    top = -np.sort(-scores, axis=1)[:, :17]
    assert (top[:, :-1] == top[:, 1:]).mean() > 0.5  # the ties were there


def test_qat_payoff_quick_on_card(dev, tmp_path):
    """``scripts.qat_payoff --quick`` on the card: both runs train through B6
    and deploy through B1 at width 64 (4 heads of 16), every metric finite."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import qat_payoff as QP

    before = dispatch.launch_counts()
    out = QP.main(["--quick", "--device=cuda", "--out", str(tmp_path / "qp.json")])
    after = dispatch.launch_counts()
    assert after["fused_layer_q8"] > before["fused_layer_q8"] and after["flash_attention_kernel"] > before[
        "flash_attention_kernel"]
    for run in ("ptq", "qat"):
        assert all(np.isfinite(v) for v in out["runs"][run].values()), out["runs"][run]
    assert out["backend"] == "cuda" and out["device"].startswith("NVIDIA")


# -- sharded serving (ROADMAP A5 (a)) -------------------------------------------


def _card_mesh(dev, n):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import make_mesh
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig

    return make_mesh(MeshConfig(data_parallel=n), [dev] * n)


def _topk_agree(got, scores, k, tol=1e-5):
    """Card top-k against the plain top-k of ``scores`` (CPU f32): values
    within ``tol``, rows equal wherever the values are no near tie."""
    gv, gi = (t.cpu() for t in got)
    wv, wi = S.topk_plain(scores, k)
    torch.testing.assert_close(gv, wv, rtol=tol, atol=tol)
    differ = gi.long() != wi.long()
    assert bool(((gv - wv).abs()[differ] <= tol).all())


@pytest.mark.parametrize("n, shard_n", [(4, 1001), (3, 999), (2, 4096)])
@pytest.mark.parametrize("mode", ["exact", "q8", "q4"])
def test_sharded_b2_on_card_matches_plain(rng, dev, n, shard_n, mode):
    """Each shard is a row view of the staged corpus (odd shard_n included)
    and launches B2 once; the merged top-k is the plain top-k of the whole
    corpus, at k below and above 128."""
    rows, d, q = n * shard_n, 256, 37
    img = rng.standard_normal((rows, d)).astype(np.float32)
    txt = rng.standard_normal((rows, d)).astype(np.float32)
    qs = _t(rng.standard_normal((q, d)), dev, torch.bfloat16)
    alpha = torch.tensor(rng.uniform(0.2, 0.8, q).astype(np.float32))
    mesh = _card_mesh(dev, n)
    if mode == "exact":
        args = (_t(img, dev, torch.bfloat16), _t(txt, dev, torch.bfloat16))
        fn = S.sharded_similarity_topk
        scores = S.blended_scores(qs.cpu(), *(a.cpu() for a in args), alpha)
    else:
        quant = S.quantize_corpus_host if mode == "q8" else S.quantize_corpus_host_q4
        (ci, si), (ct, st) = quant(img), quant(txt)
        args = tuple(torch.from_numpy(a).to(dev) for a in (ci, si, ct, st))
        fn = S.sharded_similarity_topk_q8 if mode == "q8" else S.sharded_similarity_topk_q4
        plain = S.blended_scores_q8 if mode == "q8" else S.blended_scores_q4
        scores = plain(qs.cpu(), *(a.cpu() for a in args), alpha)
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import shard_rows

    parts = shard_rows(args[0], mesh)
    row_bytes = args[0][0].numel() * args[0].element_size()
    assert [t.data_ptr() for _, t in parts.shards] == [args[0].data_ptr() + g * shard_n * row_bytes for g in range(n)]
    for k in (20, 300):
        dispatch.reset_launch_counts()
        got = fn(qs, *args, k, alpha.to(dev), mesh)
        assert dispatch.launch_counts()["similarity_topk_kernel"] == n
        _topk_agree(got, scores, k)


@pytest.mark.parametrize("n, shard_n", [(4, 1001), (2, 3000)])
def test_sharded_b5_on_card_matches_plain(rng, dev, n, shard_n):
    """B5 once a shard (codebooks replicated); the merged top-k is the plain
    top-k of the whole corpus's ADC scores (B5 is bit-equal to them)."""
    rows, d, m = n * shard_n, 128, 16
    codes_i = torch.from_numpy(rng.integers(0, 256, (rows, m), dtype=np.uint8)).to(dev)
    codes_t = torch.from_numpy(rng.integers(0, 256, (rows, m), dtype=np.uint8)).to(dev)
    sc_i = _t(rng.uniform(0.5, 1.5, (rows, 1)), dev, torch.float32)
    sc_t = _t(rng.uniform(0.5, 1.5, (rows, 1)), dev, torch.float32)
    cb_i = _t(rng.standard_normal((m, 256, d // m)), dev, torch.float32)
    cb_t = _t(rng.standard_normal((m, 256, d // m)), dev, torch.float32)
    qs = _t(rng.standard_normal((19, d)), dev, torch.bfloat16)
    args = (codes_i, sc_i, codes_t, sc_t, cb_i, cb_t)
    scores = PQ.blended_scores_pq_adc(qs.cpu(), *(a.cpu() for a in args), 0.4)
    for k in (20, 200):
        dispatch.reset_launch_counts()
        got = PQ.sharded_pq_similarity_topk(qs, *args, k, 0.4, _card_mesh(dev, n))
        assert dispatch.launch_counts()["pq_adc_topk_kernel"] == n
        _topk_agree(got, scores, k, tol=0)


def test_sharded_ivf_and_hamming_on_card_match_cpu(rng, dev):
    """The plain PyTorch sharded scans (IVF probe, sketch) give the CPU's
    answers on the card."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import binary_sketch as B
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval import ann as A

    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    img, txt = norm(rng.standard_normal((4000, 64))), norm(rng.standard_normal((4000, 64)))
    q = norm(rng.standard_normal((9, 64)))
    index = A.build_ivf_index(img, txt, 16, quantize="int8")
    cpu_mesh = _card_mesh(torch.device("cpu"), 4)
    for nprobe in (5, 16):
        want = A.sharded_ivf_search(torch.tensor(q), index, k=30, nprobe=nprobe, mesh=cpu_mesh)
        got = A.sharded_ivf_search(torch.tensor(q, device=dev), index.to(dev), k=30, nprobe=nprobe,
                                   mesh=_card_mesh(dev, 4))
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-4)
    bi, bt = (torch.from_numpy(B.pack_sign_bits_host(x).view(np.int32)) for x in (img, txt))
    want = B.sharded_hamming_topk(torch.tensor(q), bi, bt, dim=64, k=25, alpha=0.5, mesh=cpu_mesh)
    got = B.sharded_hamming_topk(torch.tensor(q, device=dev), bi.to(dev), bt.to(dev), dim=64, k=25, alpha=0.5,
                                 mesh=_card_mesh(dev, 4))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("mode", ["shard_corpus", "shard_queries"])
def test_sharded_retriever_on_card(rng, dev, mode):
    """``CLIPRetrieval`` over ``[cuda] * 4``: shard_corpus launches B2 q8
    once a shard, shard_queries B1 once a layer and B2 once for each query
    slice; the answers equal the unsharded retriever's on the card."""
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import MeshRuntime
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig

    arch = CLIPArch(256, 32, 1, 128, 16, 77, 49408, 256, 4, 2)
    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    store = EmbeddingStore(image=norm(rng.standard_normal((3001, 256))), text=norm(rng.standard_normal((3001, 256))),
                           uuids=[f"uuid-{k:06d}" for k in range(3001)])
    tok = CLIPTokenizer([("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")])
    model = build_model("tiny", dtype=torch.bfloat16, seed=0, device=dev, arch=arch)
    kw = dict(device=dev, top_k=20, quantize="int8", quantize_corpus="int8")
    plain = CLIPRetrieval(model, tok, store, **kw)
    rt = MeshRuntime.create(MeshConfig(data_parallel=4), [dev] * 4)
    sharded = CLIPRetrieval(model, tok, store, rt=rt, **{mode: True}, **kw)
    queries = [f"hello cat {'he ' * (i % 5)}" for i in range(10)]
    dispatch.reset_launch_counts()
    got = sharded.retrieval_batch(queries)
    counts = dispatch.launch_counts()
    assert counts["similarity_topk_kernel"] == 4
    assert counts["fused_layer_q8"] == (arch.text_layers * 4 if mode == "shard_queries" else arch.text_layers)
    want = plain.retrieval_batch(queries)
    for a, b in zip(got, want):
        np.testing.assert_allclose([x["score"] for x in a], [x["score"] for x in b], rtol=1e-5, atol=1e-5)
        sa, sb = [x["uuid"] for x in a], [x["uuid"] for x in b]
        for i, (u, v) in enumerate(zip(sa, sb)):
            assert u == v or abs(a[i]["score"] - b[i]["score"]) <= 1e-5


@pytest.mark.parametrize("mode", ["shard_corpus", "shard_queries"])
def test_sharded_serving_across_cards(rng, dev, mode):
    """A mesh of distinct cards (skips with fewer than two): each shard and
    each query slice launches on the card its operands live on, and the
    answers equal one card's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.data.tokenizer import CLIPTokenizer
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import MeshRuntime
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.clip_retrieval import CLIPRetrieval
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval.embedding_store import EmbeddingStore
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig

    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    arch = CLIPArch(256, 32, 1, 128, 16, 77, 49408, 256, 4, 2)
    norm = lambda x: (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)  # noqa: E731
    store = EmbeddingStore(image=norm(rng.standard_normal((4001, 256))), text=norm(rng.standard_normal((4001, 256))),
                           uuids=[f"uuid-{k:06d}" for k in range(4001)])
    tok = CLIPTokenizer([("c", "a"), ("ca", "t</w>"), ("h", "e"), ("he", "l")])
    model = build_model("tiny", dtype=torch.bfloat16, seed=0, device=cards[0], arch=arch)
    kw = dict(device=cards[0], top_k=20, quantize="int8", quantize_corpus="int8")
    rt = MeshRuntime.create(MeshConfig(data_parallel=len(cards)), cards)
    sharded = CLIPRetrieval(model, tok, store, rt=rt, **{mode: True}, **kw)
    queries = [f"hello cat {'he ' * (i % 5)}" for i in range(10)]
    got, want = sharded.retrieval_batch(queries), CLIPRetrieval(model, tok, store, **kw).retrieval_batch(queries)
    for a, b in zip(got, want):
        np.testing.assert_allclose([x["score"] for x in a], [x["score"] for x in b], rtol=1e-5, atol=1e-5)


def test_kernel_operands_on_two_cards_raise(rng, dev):
    """A kernel wrapper given operands on two cards refuses rather than
    launching on one of them (skips with fewer than two cards)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops.similarity import similarity_topk_kernel

    q = _t(rng.standard_normal((4, 64)), torch.device("cuda", 0), torch.bfloat16)
    c = _t(rng.standard_normal((256, 64)), torch.device("cuda", 1), torch.bfloat16)
    with pytest.raises(ValueError, match="several cards"):
        dispatch.operands_device((q, c), {})
    with pytest.raises(ValueError, match="several cards"):
        dispatch.operands_device((q,), {"alpha": c})
    dispatch.reset_launch_counts()
    with pytest.raises(ValueError, match="several cards"):
        similarity_topk_kernel(q, q, c, c, None, None, torch.full((4, 1), 0.5, device=q.device), 5)
    assert dispatch.launch_counts()["similarity_topk_kernel"] == 0


def _parallel_step(devices, layout, model, batch, cfg):
    """One train step over a mesh of ``devices`` with ``layout``: (loss, grad_norm, whole parameters)."""
    import copy

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import MeshRuntime
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig

    m = copy.deepcopy(model)
    if devices is None:
        state = TT.TrainState(m, TT.make_optimizer(cfg, 1, m))
        state, met = TT.make_train_step(m, cfg)(state, {k: v.to(m.logit_scale.device) for k, v in batch.items()})
        return float(met["loss"]), float(met["grad_norm"]), {n: p.detach() for n, p in m.named_parameters()}
    rt = MeshRuntime.create(MeshConfig(**layout), devices)
    if rt.fsdp or rt.mesh.shape[rt.model_axis] > 1:
        state = (TT.init_state_fsdp if rt.fsdp else TT.init_state_gspmd)(m, cfg, rt, 1)
        step = TT.make_train_step_gspmd(m, cfg, rt, state.layout)
    else:
        state = TT.TrainState(m, TT.make_optimizer(cfg, 1, m))
        step = TT.make_train_step(m, cfg, rt=rt)
    state, met = step(state, batch)
    return float(met["loss"]), float(met["grad_norm"]), state.whole(state.params()) if state.layout is not None else {
        n: p.detach() for n, p in m.named_parameters()}


def _parallel_world(rng, dev):
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    arch = CLIPArch(64, 32, 1, 64, 16, 16, 256, 64, 2, 1, vision_heads=2)
    model = build_model("tiny", dtype=torch.float32, seed=0, device=dev, arch=arch)
    b = 8
    batch = {"images": torch.from_numpy(rng.standard_normal((b, 32, 32, 3)).astype(np.float32)),
             "query_ids": torch.from_numpy(rng.integers(1, 250, (b, 16))),
             "target_ids": torch.from_numpy(rng.integers(1, 250, (b, 16)))}
    # lr 1e-3 (the CPU tests' rate): AdamW's first step moves a parameter by
    # about lr, far above the 2e-5 the parameters are held to
    return model, batch, TrainConfig(batch_size=b, global_negatives=True, lr=1e-3)


_LAYOUTS = {"dp2": dict(data_parallel=2), "fsdp2": dict(data_parallel=2, fsdp=True),
            "tp2": dict(data_parallel=1, model_parallel=2)}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_parallel_train_steps_on_one_card(rng, dev, layout):
    """The DP, FSDP and TP steps over ``[cuda:0] * 2`` (f32, TF32 off,
    global negatives) equal the one-device step (loss 1e-5, parameters
    2e-5, grad_norm 1e-5 relative), and every shard's towers launched the
    attention kernel: once a tower, and once more in the GSPMD step's
    backward, which recomputes each block (``parallel.fsdp.BlockGather``)."""
    model, batch, cfg = _parallel_world(rng, dev)
    want_loss, want_norm, want = _parallel_step(None, None, model, batch, cfg)
    dispatch.reset_launch_counts()
    loss, norm, got = _parallel_step([torch.device("cuda", 0)] * 2, _LAYOUTS[layout], model, batch, cfg)
    shards = 2 if layout != "tp2" else 1
    passes = 1 if layout == "dp2" else 2
    # image, query, target towers a shard (one layer each)
    assert dispatch.launch_counts()["flash_attention_kernel"] == 3 * shards * passes
    assert loss == pytest.approx(want_loss, abs=1e-5)
    assert norm == pytest.approx(want_norm, rel=1e-5)
    for n, p in want.items():
        torch.testing.assert_close(got[n].to(p.device), p, rtol=0, atol=2e-5, msg=n)


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_parallel_train_steps_across_cards(rng, dev, layout):
    """The same steps over two distinct cards (skips with fewer than two):
    each shard on its card, gradients back on the card of the optimizer state."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    model, batch, cfg = _parallel_world(rng, dev)
    want_loss, want_norm, want = _parallel_step(None, None, model, batch, cfg)
    loss, norm, got = _parallel_step([torch.device("cuda", 0), torch.device("cuda", 1)], _LAYOUTS[layout], model,
                                     batch, cfg)
    assert loss == pytest.approx(want_loss, abs=1e-5)
    assert norm == pytest.approx(want_norm, rel=1e-5)
    for n, p in want.items():
        torch.testing.assert_close(got[n].to(p.device), p, rtol=0, atol=2e-5, msg=n)


def test_fsdp_peak_below_dp_on_each_card(rng, dev):
    """ViT-L/14, bf16 compute, batch 64 over every visible card (skips with
    fewer than two): DP and FSDP, two steps each; prints each card's peak
    (``max_memory_allocated``) for both. FSDP holds 1/n of the state on
    each card, builds one unit at a time and keeps each block's input only;
    DP keeps a whole replica with its activations on each card: FSDP's peak
    is the lower on every card."""
    import copy
    import json

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import MeshRuntime
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig, TrainConfig

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA devices")
    cards = [torch.device("cuda", i) for i in range(n)]
    base = build_model("ViT-L/14", dtype=torch.bfloat16, seed=0, device=cards[0])
    b = 64
    batch = {"images": torch.from_numpy(rng.standard_normal((b, 224, 224, 3)).astype(np.float32)),
             "query_ids": torch.from_numpy(rng.integers(1, 49000, (b, 77))),
             "target_ids": torch.from_numpy(rng.integers(1, 49000, (b, 77)))}
    cfg = TrainConfig(batch_size=b, global_negatives=True)
    peaks, step_ms = {}, {}
    for tag, layout in (("dp", dict(data_parallel=n)), ("fsdp", dict(data_parallel=n, fsdp=True))):
        m = copy.deepcopy(base)
        rt = MeshRuntime.create(MeshConfig(**layout), cards)
        if rt.fsdp:
            state = TT.init_state_fsdp(m, cfg, rt, 1)
            step = TT.make_train_step_gspmd(m, cfg, rt, state.layout)
        else:
            state = TT.TrainState(m, TT.make_optimizer(cfg, 1, m))
            step = TT.make_train_step(m, cfg, rt=rt)
        shards = TT.as_row_shards(batch, rt)
        for c in cards:
            torch.cuda.synchronize(c)
            torch.cuda.reset_peak_memory_stats(c)
        times = []
        for _ in range(2):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, met = step(state, shards)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            assert np.isfinite(float(met["loss"]))
        for c in cards:
            torch.cuda.synchronize(c)
        peaks[tag] = [torch.cuda.max_memory_allocated(c) for c in cards]
        step_ms[tag] = times
        del m, state, step, shards
        for c in cards:
            with torch.cuda.device(c):
                torch.cuda.empty_cache()
    print("fsdp / dp peaks a card:", json.dumps({"cards": n, "name": torch.cuda.get_device_name(0),
                                                  "peak_bytes": peaks, "step_ms": step_ms}))
    for i in range(n):
        assert peaks["fsdp"][i] < peaks["dp"][i], (i, peaks)


def test_pp_and_ep_across_two_cards_over_nccl(dev, tmp_path):
    """Two ranks, one card each, over NCCL (skips with fewer than two
    cards): ``pipeline_apply`` and the expert-sharded ``moe_apply`` with
    the axis across the processes (``tests/mp_torch_pp_sp_ep_worker.py``'s
    ``pp A2`` / ``moe A2``, each rank's rows of the other's stages or
    experts NaN) against one process over both cards: every rank's output,
    and the gradients in its rows, at the CPU test's tolerances. The hops
    and reductions crossed as device tensors (no byte through the host)."""
    import importlib.util
    import os
    import socket
    import subprocess
    import sys

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import Mesh

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # by path: an installed package named ``tests`` may shadow this directory
    spec = importlib.util.spec_from_file_location("mp_torch_pp_sp_ep_worker",
                                                  os.path.join(root, "tests", "mp_torch_pp_sp_ep_worker.py"))
    W = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(W)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    logs = [open(tmp_path / f"w{r}.log", "w+") for r in range(2)]
    procs = []
    try:
        procs = [subprocess.Popen([sys.executable, os.path.join(root, "tests", "mp_torch_pp_sp_ep_worker.py"), str(r),
                                   "2", port, str(tmp_path), "cuda"], env=env, stdout=log, stderr=subprocess.STDOUT,
                                  text=True) for r, log in enumerate(logs)]
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, f"worker failed:\n{text[-4000:]}"
    ranks = [torch.load(tmp_path / f"r{r}.pt", weights_only=False) for r in range(2)]
    arr = np.empty(2, dtype=object)
    arr[:] = [torch.device("cuda", 0), torch.device("cuda", 1)]
    tol = {"pp": (2e-5, 1e-4), "moe": (1e-5, 2e-5)}
    for name, kind, key in (("pp A2", "pp", "stage."), ("moe A2", "moe", "param.")):
        axis = {"pp": "pipe", "moe": "expert"}[kind]
        one = W.compute(kind, W.inputs(kind, 2), Mesh(arr, (axis,)))
        for r, rank in enumerate(ranks):
            assert rank["backend"] == "nccl"
            rep = rank[name]
            assert rep["positions"] == [r] and rep["hops"]["reduce"]["host_bytes"] == 0
            if kind == "pp":
                assert rep["hops"]["p2p"]["bytes"] > 0 and rep["hops"]["p2p"]["host_bytes"] == 0
            torch.testing.assert_close(rep["out"], one["out"], rtol=tol[kind][0], atol=tol[kind][0])
            for g_name, g in rep["grads"].items():
                want = one["grads"][g_name]
                if g_name.startswith(key):  # cut by stage or expert: this rank's rows, zeros in the other's
                    per = g.shape[0] // 2
                    torch.testing.assert_close(g[r * per:(r + 1) * per], want[r * per:(r + 1) * per],
                                               rtol=tol[kind][1], atol=tol[kind][1], msg=f"{name} {g_name}")
                    assert not g[(1 - r) * per:(2 - r) * per].any()
                else:
                    torch.testing.assert_close(g, want, rtol=tol[kind][1], atol=tol[kind][1], msg=f"{name} {g_name}")
