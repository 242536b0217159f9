"""The port's attention held to the JAX package.

``flash_attention_plain`` (the CPU route of the port's B6/B7 kernel) is held
to the Pallas ``short_attention`` and ``flash_attention`` kernels in
interpret mode, at the sizes and the 2e-3 tolerance of
``tests/test_short_attention.py`` / ``tests/test_flash_attention.py`` in f32
and at their 3e-2 in bf16, where the port rounds p to bf16 before p@v as its
tensor-core kernel does (and is held to ``mha_plain``, which rounds there too);
``mha_plain`` to ``mha_xla``; the autograd gradient to ``jax.vjp`` of
``mha_xla``. Inputs are seeded numpy arrays handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.ops.attention import mha_xla
from knowledge_enhanced_multimodal_retrieval_tpu.ops.flash_attention import flash_attention as j_flash
from knowledge_enhanced_multimodal_retrieval_tpu.ops.short_attention import short_attention as j_short
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import flash_attention as FA
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops.attention import mha, mha_plain


def _qkv(rng, b, h, s, d, sk=None):
    sk = s if sk is None else sk
    return (
        rng.standard_normal((b, h, s, d)).astype(np.float32),
        rng.standard_normal((b, h, sk, d)).astype(np.float32),
        rng.standard_normal((b, h, sk, d)).astype(np.float32),
    )


def _torch(arrs, dtype=torch.float32):
    return [torch.tensor(a).to(dtype) for a in arrs]


def _jax(arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrs]


@pytest.mark.parametrize("s", [50, 77, 128, 257])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_short_attention_kernel(rng, s, causal):
    arrs = _qkv(rng, 2, 4, s, 32)
    want = np.asarray(j_short(*_jax(arrs), causal=causal, interpret=True))
    got = FA.flash_attention(*_torch(arrs), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("s", [64, 77, 128, 200, 257, 577])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_flash_attention_kernel(rng, s, causal):
    b, h = (1, 2) if s > 512 else (2, 3)
    arrs = _qkv(rng, b, h, s, 64)
    want = np.asarray(j_flash(*_jax(arrs), causal=causal, interpret=True))
    got = FA.flash_attention(*_torch(arrs), causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_plain_matches_flash_attention_kernel_other_key_length(rng):
    """Query and key lengths differ (the Pallas kernel pads and masks each
    to its own block multiple)."""
    arrs = _qkv(rng, 1, 2, 70, 32, sk=150)
    want = np.asarray(j_flash(*_jax(arrs), causal=False, block_q=64, block_k=64, interpret=True))
    np.testing.assert_allclose(FA.flash_attention(*_torch(arrs)).numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("kernel", ["short", "flash"])
def test_plain_bf16_matches_pallas(rng, kernel):
    arrs = _qkv(rng, 2, 4, 257, 64)
    jfn = j_short if kernel == "short" else j_flash
    want = jfn(*_jax(arrs, jnp.bfloat16), interpret=True)
    got = FA.flash_attention(*_torch(arrs, torch.bfloat16))
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    # the Pallas kernels keep p in f32 through p@v, the port rounds p to bf16
    # (2^-9 relative per weight, averaged over the keys) and both round the
    # output once: the tolerance the JAX tests hold the kernels to in bf16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("s", [77, 257, 577])
@pytest.mark.parametrize("causal", [False, True])
def test_plain_bf16_rounds_p_like_mha_plain(rng, s, causal):
    """In bf16 ``flash_attention_plain`` rounds the unnormalized p to bf16
    before p@v and divides after it; ``mha_plain`` rounds the logits and the
    normalized weights to bf16. The two differ by those roundings: two bf16
    steps of the output, or, where the weighted values cancel, one step of
    the O(1) terms that were summed (2^-7)."""
    q, k, v = _torch(_qkv(rng, 1, 2, s, 64), torch.bfloat16)
    got = FA.flash_attention_plain(q, k, v, causal).float().numpy()
    want = mha_plain(q, k, v, causal).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -6, atol=2.0 ** -7)


def test_plain_bf16_p_is_rounded_before_the_product(rng):
    """The bf16 route is not the f32 route cast at the end: with p kept in
    f32 some outputs land on another bf16 value."""
    q, k, v = _torch(_qkv(rng, 1, 2, 257, 64), torch.bfloat16)
    rounded = FA.flash_attention_plain(q, k, v).float()
    unrounded = FA.flash_attention_plain(q.float(), k.float(), v.float()).to(torch.bfloat16).float()
    assert (rounded != unrounded).any()
    np.testing.assert_allclose(rounded.numpy(), unrounded.numpy(), rtol=2.0 ** -6, atol=2.0 ** -7)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mha_plain_matches_mha_xla(rng, causal, dtype):
    arrs = _qkv(rng, 2, 3, 77, 64)
    tdt, jdt, tol = (torch.float32, jnp.float32, 1e-5) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16, 3e-2)
    want = np.asarray(mha_xla(*_jax(arrs, jdt), causal=causal), np.float32)
    got = mha_plain(*_torch(arrs, tdt), causal=causal).float().numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("s,causal", [(50, True), (150, False), (150, True)])
def test_gradient_matches_jax_vjp_of_mha_xla(rng, s, causal):
    arrs = _qkv(rng, 1, 2, s, 16)
    g = rng.standard_normal((1, 2, s, 16)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: mha_xla(q, k, v, causal=causal), *_jax(arrs))
    want = vjp(jnp.asarray(g))
    qkv = [t.requires_grad_() for t in _torch(arrs)]
    got = torch.autograd.grad(FA.flash_attention(*qkv, causal=causal), qkv, torch.tensor(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3, atol=2e-3)


def test_cpu_routes_to_plain_versions(rng):
    """On the CPU ``mha`` is ``mha_plain`` at every length (the JAX package
    runs XLA off the TPU) and no kernel launch is counted."""
    before = FA.flash_attention_kernel.launches
    for s in (77, 257):
        q, k, v = _torch(_qkv(rng, 1, 2, s, 64))
        assert torch.equal(mha(q, k, v), mha_plain(q, k, v))
        FA.flash_attention(q, k, v)
    assert FA.flash_attention_kernel.launches == before
