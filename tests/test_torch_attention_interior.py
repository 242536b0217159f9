"""The port's attention interior (plain version) held to the JAX package's.

``_attention_interior`` is the arithmetic between the projections of B3a, B1,
B4a and S1: f32 scores scaled after the dot, ``-1e9`` where hidden, f32
softmax, p normalized and then cast to the activation dtype, p @ v in f32.
The JAX function is a plain ``jnp`` function and is called directly; the
no-max interior is the JAX profiler script's ``_interior_nomax``, loaded by
path as ``tests/test_torch_profile_interior.py`` loads it. The same
numpy-seeded ``qkv`` goes to both. On the CPU the port's wrapper
(``attention_interior``) runs the plain version; the kernel's route counter
has no CPU mode and must say so.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.ops import fused_block as J
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as T

REPO = Path(__file__).resolve().parent.parent
W, H = 128, 2

# f32: the same operations in the same order, sums in another (1e-5).
# bf16: p and the output each round once; an f32 ulp can move either by one
# bf16 step. Outputs here are |o| < 4, where a step is 2^-6.
F32_TOL = 1e-5
BF16_STEP = 2.0 ** -6


@pytest.fixture(scope="module")
def jscript():
    """The JAX profiler script as a module (only its plain ``jnp`` interior
    is called here, so its Pallas calls stay as they are)."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))  # the script imports ``bench`` from the repo root
    spec = importlib.util.spec_from_file_location("_jax_profile_vision_interior_ai", REPO / "scripts/profile_vision_interior.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _qkv(rng, nseq, s):
    return rng.standard_normal((nseq * s, 3 * W)).astype(np.float32)


def _mask_lens(s):
    return sorted({1, s - 3, s})


def _jax_interior(fn, qkv, s, mask_len, causal, dtype):
    out = fn(jnp.asarray(qkv).astype(dtype), tile=qkv.shape[0], seq_len=s, mask_len=mask_len, heads=H, causal=causal,
             out_dtype=dtype)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [16, 43, 80, 272])
def test_interior_f32_matches_jax(rng, s, causal):
    nseq = 3
    qkv = _qkv(rng, nseq, s)
    for mask_len in _mask_lens(s):
        want = _jax_interior(J._attention_interior, qkv, s, mask_len, causal, jnp.float32)
        got = T._attention_interior(
            torch.tensor(qkv), seq_len=s, mask_len=mask_len, heads=H, causal=causal, out_dtype=torch.float32
        )
        assert got.shape == (nseq * s, W) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL, err_msg=f"mask_len {mask_len}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("s", [16, 43, 80, 272])
def test_interior_bf16_matches_jax(rng, s, causal):
    qkv = _qkv(rng, 2, s)
    for mask_len in _mask_lens(s):
        want = _jax_interior(J._attention_interior, qkv, s, mask_len, causal, jnp.bfloat16)
        got = T._attention_interior(
            torch.tensor(qkv).bfloat16(), seq_len=s, mask_len=mask_len, heads=H, causal=causal,
            out_dtype=torch.bfloat16,
        )
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_STEP, rtol=0, err_msg=f"mask_len {mask_len}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s", [16, 43, 80, 272])
def test_nomax_interior_matches_the_jax_script(jscript, rng, s, dtype):
    """``subtract_max=False`` against the script's ``_interior_nomax`` (not
    causal, as the vision tower runs it)."""
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    qkv = _qkv(rng, 3, s) * 0.5
    for mask_len in _mask_lens(s):
        want = _jax_interior(jscript._interior_nomax, qkv, s, mask_len, False, jd)
        got = T._attention_interior(
            torch.tensor(qkv).to(td), seq_len=s, mask_len=mask_len, heads=H, causal=False, out_dtype=td,
            subtract_max=False,
        )
        if dtype == "f32":
            np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL, err_msg=f"mask_len {mask_len}")
        else:
            np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_STEP, rtol=0, err_msg=f"mask_len {mask_len}")


@pytest.mark.parametrize("s,nseq", [(16, 5), (43, 2)])
def test_sequences_do_not_see_each_other(rng, s, nseq):
    """Changing one sequence's rows changes that sequence's output only."""
    qkv = torch.tensor(_qkv(rng, nseq, s))
    kw = dict(seq_len=s, mask_len=s - 3, heads=H, causal=False, out_dtype=torch.float32)
    base = T._attention_interior(qkv, **kw)
    other = qkv.clone()
    other[s : 2 * s] += 1.0
    moved = T._attention_interior(other, **kw)
    assert torch.equal(moved[:s], base[:s]) and torch.equal(moved[2 * s :], base[2 * s :])
    assert not torch.equal(moved[s : 2 * s], base[s : 2 * s])


@pytest.mark.parametrize("subtract_max", [True, False], ids=["production", "no-max"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_wrapper_runs_the_plain_version_on_the_cpu(rng, causal, subtract_max):
    qkv = torch.tensor(_qkv(rng, 3, 16)).bfloat16()
    kw = dict(seq_len=16, heads=H, mask_len=13, causal=causal)
    got = T.attention_interior(qkv, subtract_max=subtract_max, **kw)
    want = T._attention_interior(qkv, out_dtype=torch.bfloat16, subtract_max=subtract_max, **kw)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # mask_len defaults to the whole sequence
    full = T.attention_interior(qkv, seq_len=16, heads=H, causal=causal, subtract_max=subtract_max)
    assert torch.equal(full, T._attention_interior(qkv, seq_len=16, heads=H, mask_len=16, causal=causal,
                                                   out_dtype=torch.bfloat16, subtract_max=subtract_max))


def test_wrapper_checks_its_arguments():
    with pytest.raises(ValueError, match="3 \\* width"):
        T.attention_interior(torch.zeros(16, 3 * W + 1), seq_len=16, heads=H)
    with pytest.raises(ValueError, match="whole sequences"):
        T.attention_interior(torch.zeros(17, 3 * W), seq_len=16, heads=H)
    with pytest.raises(ValueError, match="even heads"):
        T.attention_interior(torch.zeros(16, 3 * W), seq_len=16, heads=3)
    with pytest.raises(ValueError, match="no kernel or plain route"):
        T.attention_interior(torch.zeros(16, 3 * W, device="meta"), seq_len=16, heads=H)


@pytest.mark.parametrize("reader", ["attention_route_counts", "force_row_attention"])
def test_route_readers_need_the_kernel_library(tmp_path, monkeypatch, reader):
    """The route counter and the route switch live in the CUDA library: on a
    machine without ``nvcc`` they raise the loader's error and build nothing."""
    monkeypatch.setattr(dispatch, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(dispatch, "NVCC_FALLBACK", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(dispatch, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):  # the loader's own error class
        getattr(T, reader)(*(() if reader == "attention_route_counts" else (True,)))
    assert not any((tmp_path / "_build").glob("*.so")) if (tmp_path / "_build").exists() else True


def test_interior_source_is_part_of_the_build_key():
    assert "attention_interior.cuh" in {p.name for p in dispatch.kernel_sources()}
