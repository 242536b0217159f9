"""The layer kernels' GEMM contract on the CPU: the plain version of one
GEMM with one epilogue, the K-major weight copies and ``mha``'s routing rule.

The GEMM kernel itself runs only on the card (``tests/test_torch_cuda.py``);
here its plain version is held to numpy and, composed into whole blocks, to
the plain versions of B3b and B4b, which ``tests/test_torch_fused_block.py``
and ``tests/test_torch_block_q8.py`` hold to the JAX package.
"""

import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import attention as A
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as FB


@pytest.fixture()
def rng():
    return np.random.default_rng(7)


def _bf(a):
    """numpy f32 -> rounded to bf16 -> f32."""
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16).float().numpy()


def _operands(rng, m, n, k, int8):
    bias = (0.1 * rng.standard_normal(n)).astype(np.float32)
    res = _bf(rng.standard_normal((m, n)))
    if int8:
        a, b = rng.integers(-127, 128, (m, k)), rng.integers(-127, 128, (k, n))
        rs = rng.uniform(1e-3, 2e-3, m).astype(np.float32)
        cs = rng.uniform(1e-3, 2e-3, n).astype(np.float32)
        v = (a @ b).astype(np.float32) * rs[:, None] * cs[None, :]
        ta, tb = torch.tensor(a, dtype=torch.int8), torch.tensor(b, dtype=torch.int8)
        kw = dict(row_scale=torch.tensor(rs), col_scale=torch.tensor(cs))
    else:
        a, b = _bf(rng.standard_normal((m, k))), _bf(0.05 * rng.standard_normal((k, n)))
        cs = rng.uniform(0.5, 1.5, n).astype(np.float32)
        v = (a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)
        ta, tb = torch.tensor(a).to(torch.bfloat16), torch.tensor(b).to(torch.bfloat16)
        kw = dict(col_scale=torch.tensor(cs))
    kw.update(bias=torch.tensor(bias), res=torch.tensor(res).to(torch.bfloat16))
    return ta, tb, kw, v, bias, res, cs


def _gelu(f):
    return f * (1.0 / (1.0 + np.exp(-1.702 * f)))


_CASES = [(True, e) for e in FB._EPI_INT8] + [(False, e) for e in FB._EPI_BF16]


@pytest.mark.parametrize("int8,epi", _CASES, ids=[f"{'int8' if i else 'bf16'}-epi{e}" for i, e in _CASES])
@pytest.mark.parametrize("m,n,k", [(5, 24, 48), (130, 72, 208)])
def test_gemm_epilogue_plain_matches_numpy(rng, int8, epi, m, n, k):
    ta, tb, kw, v, bias, res, cs = _operands(rng, m, n, k, int8)
    if epi == FB.EPI_SCALE_ACC_F32:
        v = v * cs[None, :]
    got = FB.gemm_epilogue(ta, tb, epi, **kw)  # a CPU tensor: the plain version
    if epi in (FB.EPI_ACC_F32, FB.EPI_SCALE_ACC_F32):
        # first and only chunk; then a second chunk on top of an f32 accumulator
        want = _bf(res + _bf(v + bias))
        acc = FB.gemm_epilogue(ta, tb, epi, last=False, **kw)
        assert acc.dtype == torch.float32
        np.testing.assert_allclose(acc.numpy(), v, rtol=1e-5, atol=1e-5)
        two = FB.gemm_epilogue(ta, tb, epi, acc=acc, last=True, **kw)
        np.testing.assert_allclose(two.float().numpy(), _bf(res + _bf(2 * v + bias)), rtol=0, atol=2 ** -5)
    elif epi == FB.EPI_BIAS_BF16:
        want = _bf(v + bias)
    elif epi == FB.EPI_BIAS_RES_BF16:
        want = _bf(res + _bf(v + bias))
    elif epi == FB.EPI_BIAS_GELU_BF16:
        want = _bf(_gelu(v + bias))
    elif epi == FB.EPI_BIAS_GELU_F32:
        want = _gelu(v + bias)
    else:
        want = v + bias
    f32_out = epi in (FB.EPI_BIAS_GELU_F32, FB.EPI_BIAS_F32)
    assert got.dtype == (torch.float32 if f32_out else torch.bfloat16) and tuple(got.shape) == (m, n)
    # f32 results: the sums in another order; bf16 results: at most one step at |x| < 8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-4 if f32_out else 2 ** -5)


def test_gemm_epilogues_compose_into_the_block_plain_versions(rng):
    """B3b and B4b written as the GEMM calls their kernels make (one epilogue
    each, the int8 c_proj accumulated over the FF chunks) are the blocks'
    plain versions bit for bit: the epilogues mean what the blocks compute."""
    n, w, ff, chunks = 24, 64, 256, 2
    t = lambda a, dt=torch.float32: torch.tensor(np.asarray(a, np.float32)).to(dt)  # noqa: E731
    x = t(rng.standard_normal((n, w)), torch.bfloat16)
    g, c = t(1 + 0.1 * rng.standard_normal(w)), t(0.1 * rng.standard_normal(w))
    w1, w2 = t(0.05 * rng.standard_normal((w, ff))), t(0.05 * rng.standard_normal((ff, w)))
    b1, b2 = t(0.02 * rng.standard_normal(ff)), t(0.02 * rng.standard_normal(w))
    h = FB._ln_f32(x, g, c, 1e-5)
    # B3b
    bw1, bw2 = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
    f = FB.gemm_epilogue(h.to(torch.bfloat16), bw1, FB.EPI_BIAS_GELU_BF16, bias=b1)
    got = FB.gemm_epilogue(f, bw2, FB.EPI_BIAS_RES_BF16, bias=b2, res=x)
    assert torch.equal(got, FB.mlp_block_plain(x, g, c, bw1, b1, bw2, b2, eps=1e-5))
    # B4b
    (w1q, w1s), (w2q, w2s) = FB.quantize_weight(w1), FB.quantize_weight(w2)
    hq, hr = FB._quantize_rows(h)
    ck, acc = ff // chunks, None
    for i in range(chunks):
        sl = slice(i * ck, (i + 1) * ck)
        fc = FB.gemm_epilogue(hq, w1q[:, sl].contiguous(), FB.EPI_BIAS_GELU_F32, bias=b1[sl],
                              row_scale=hr.reshape(-1), col_scale=w1s[0, sl])
        fq, fr = FB._quantize_rows(fc)
        acc = FB.gemm_epilogue(fq, w2q[sl].contiguous(), FB.EPI_ACC_F32, bias=b2, row_scale=fr.reshape(-1),
                               col_scale=w2s[0], res=x, acc=acc, last=i == chunks - 1)
    assert torch.equal(acc, FB.mlp_block_q8_plain(x, g, c, w1q, w1s, b1, w2q, w2s, b2, n_chunks=chunks, eps=1e-5))


def test_k_major_is_the_exact_transpose(rng):
    w = torch.tensor(rng.integers(-127, 128, (48, 80)), dtype=torch.int8)
    wt = FB.k_major(w)
    assert wt.dtype == torch.int8 and tuple(wt.shape) == (80, 48) and wt.is_contiguous()
    assert torch.equal(wt, w.t()) and torch.equal(FB.k_major(wt), w)


def test_k_major_operands_check_the_given_copies(rng):
    w = torch.tensor(rng.integers(-127, 128, (48, 80)), dtype=torch.int8)
    made, kept = FB._k_major_operands((w, w), (None, FB.k_major(w)), ("a_qt", "b_qt"))
    assert torch.equal(made, kept)
    with pytest.raises(ValueError, match="a_qt has shape"):
        FB._k_major_operands((w,), (w,), ("a_qt",))
    with pytest.raises(ValueError, match="a_qt must be contiguous"):
        FB._k_major_operands((w,), (w.t(),), ("a_qt",))
    with pytest.raises(ValueError, match="a_qt has dtype"):
        FB._k_major_operands((w,), (FB.k_major(w).float(),), ("a_qt",))


class _CardTensor:
    """What ``mha`` reads of a tensor, saying it lies on the card."""

    is_cuda = True

    def __init__(self, *shape):
        self.shape = torch.Size(shape)

    def contiguous(self):
        return self


@pytest.mark.parametrize("s", [1, 16, 77, 128, 129, 577])
@pytest.mark.parametrize("d", [32, 64, 256])
def test_mha_sends_every_length_on_the_card_to_the_kernel(monkeypatch, s, d):
    """No sequence-length threshold: a CUDA tensor whose head dim the kernel
    has launches it at every length."""
    calls = []
    monkeypatch.setattr(A, "flash_attention", lambda q, k, v, causal=False: calls.append((q.shape, causal)) or "kernel")
    monkeypatch.setattr(A, "mha_plain", lambda q, k, v, causal=False: "plain")
    q = _CardTensor(2, 4, s, d)
    assert A.mha(q, q, q, causal=True) == "kernel" and calls == [(q.shape, True)]


def test_mha_runs_the_plain_version_off_the_card_and_for_wide_heads(monkeypatch, rng):
    monkeypatch.setattr(A, "flash_attention", lambda *a, **k: pytest.fail("no kernel for this input"))
    q = torch.tensor(rng.standard_normal((1, 2, 200, 16)).astype(np.float32))
    assert torch.equal(A.mha(q, q, q, causal=True), A.mha_plain(q, q, q, causal=True))
    monkeypatch.setattr(A, "mha_plain", lambda q, k, v, causal=False: "plain")
    wide = _CardTensor(1, 2, 200, A.MAX_HEAD_DIM + 8)
    assert A.mha(wide, wide, wide) == "plain"
