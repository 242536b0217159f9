"""The port's hand-written kernels held to their plain versions on the card.

Every case needs a CUDA device and skips without one. The file imports no
JAX, so it also runs on a machine without it, without this suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.clip import CLIPArch, build_text_model
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fast_encode import encode_text_fast, make_text_plan
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as T
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as S

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


def _attn(rng, dev, width=W):
    f32, bf = torch.float32, torch.bfloat16
    return dict(
        ln_scale=_t(1 + 0.1 * rng.standard_normal(width), dev, f32),
        ln_bias=_t(0.1 * rng.standard_normal(width), dev, f32),
        wqkv=_t(rng.standard_normal((width, 3 * width)) * 0.05, dev, bf),
        bqkv=_t(0.02 * rng.standard_normal(3 * width), dev, f32),
        wo=_t(rng.standard_normal((width, width)) * 0.05, dev, bf),
        bo=_t(0.02 * rng.standard_normal(width), dev, f32),
    )


def _mlp(rng, dev, width=W, ff=FF):
    f32, bf = torch.float32, torch.bfloat16
    return dict(
        ln_scale=_t(1 + 0.1 * rng.standard_normal(width), dev, f32),
        ln_bias=_t(0.1 * rng.standard_normal(width), dev, f32),
        w1=_t(rng.standard_normal((width, ff)) * 0.05, dev, bf),
        b1=_t(0.02 * rng.standard_normal(ff), dev, f32),
        w2=_t(rng.standard_normal((ff, width)) * 0.05, dev, bf),
        b2=_t(0.02 * rng.standard_normal(width), dev, f32),
    )


def _close(got, want, atol):
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), atol=atol, rtol=0)


@pytest.mark.parametrize(
    "s,mask_len,causal,nseq", [(16, 16, True, 8), (16, 12, True, 3), (32, 27, True, 5), (16, 16, False, 4), (80, 77, True, 2)]
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


@pytest.mark.parametrize("s,mask_len,nseq", [(16, 16, 3), (32, 27, 8)])
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


def test_kernels_refuse_wrong_operands(rng, dev):
    x = _t(rng.standard_normal((32, W)), dev, torch.float32)  # kernels take bf16 activations
    with pytest.raises(ValueError, match="dtype"):
        T.fused_attention_block(x, **_attn(rng, dev), seq_len=16, heads=H)
    w = {k: v.cpu() for k, v in _mlp(rng, dev).items()}
    with pytest.raises(ValueError, match="expected cuda"):
        T.fused_mlp_block(x.bfloat16(), **w)


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


def test_encode_text_fast_on_card_matches_cpu_plan(rng, dev):
    arch = CLIPArch(64, 32, 1, 128, 16, 77, 49408, W, H, 2)
    model = build_text_model("", arch=arch, seed=1)
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
