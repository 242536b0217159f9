"""The port's vision-interior profiler (S1, S2) held to the JAX script.

``scripts/profile_vision_interior.py`` is loaded by path; its two
``pallas_call`` sites take no ``interpret`` argument, so the module's ``pl``
name is swapped for one whose ``pallas_call`` adds ``interpret=True``: the
script's own functions then run on the CPU. The port's wrappers run their
plain versions here; the same numpy inputs go to both.
"""

import functools
import importlib.util
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.ops import fused_block as J
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import fused_block as T
from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import profile_vision_interior as P

REPO = Path(__file__).resolve().parent.parent
W, H, FF, S = 128, 2, 512, 16

# as tests/test_torch_block_q8.py: f32 rounding for nearly every value, a
# quantization step for the few whose int8 rounding flipped on an f32 ulp
TOL, QUANT_STEP_ATOL, FLIPPED_SHARE = 1e-3, 0.02, 5e-3


def _assert_q8_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=QUANT_STEP_ATOL, rtol=0)
    off = np.abs(got - want) > TOL + TOL * np.abs(want)
    assert off.mean() <= FLIPPED_SHARE, f"{off.mean():.4%} of the values differ by more than a rounding"


@pytest.fixture(scope="module")
def jscript():
    """The JAX script as a module, its Pallas calls in interpret mode."""
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))  # the script imports ``bench`` from the repo root
    spec = importlib.util.spec_from_file_location("_jax_profile_vision_interior", REPO / "scripts/profile_vision_interior.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    real = mod.pl
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(real.pallas_call, interpret=True), BlockSpec=real.BlockSpec
    )
    return mod


def _layer_plan(rng):
    """One int8 layer plan (the keys ``make_vision_plan`` packs), as torch."""
    f = lambda v: torch.tensor(np.asarray(v, np.float32))  # noqa: E731
    lp = {
        "ln1_scale": f(1 + 0.1 * rng.standard_normal(W)), "ln1_bias": f(0.1 * rng.standard_normal(W)),
        "bqkv": f(0.02 * rng.standard_normal(3 * W)), "bo": f(0.02 * rng.standard_normal(W)),
        "ln2_scale": f(1 + 0.1 * rng.standard_normal(W)), "ln2_bias": f(0.1 * rng.standard_normal(W)),
        "b1": f(0.02 * rng.standard_normal(FF)), "b2": f(0.02 * rng.standard_normal(W)),
    }
    for name, shape in (("wqkv", (W, 3 * W)), ("wo", (W, W)), ("w1", (W, FF)), ("w2", (FF, W))):
        lp[name], lp[name + "_s"] = T.quantize_weight(f(rng.standard_normal(shape) * 0.05))
    return lp


def _jlp(lp):
    return {k: jnp.asarray(v.numpy()) for k, v in lp.items()}


@pytest.mark.parametrize("mask_len", [S, 13])
@pytest.mark.parametrize("interior", [P.INTERIOR_PRODUCTION, P.INTERIOR_NOMAX])
def test_attn_q8_variant_matches_the_jax_script(jscript, rng, interior, mask_len):
    lp = _layer_plan(rng)
    x = (rng.standard_normal((4 * S, W)) * 0.5).astype(np.float32)
    j_interior = J._attention_interior if interior == P.INTERIOR_PRODUCTION else jscript._interior_nomax
    want = jscript.attn_q8_variant(
        jnp.asarray(x), _jlp(lp), seq_len=S, heads=H, mask_len=mask_len, tile=4 * S, interior=j_interior
    )
    got = P.attn_q8_variant(torch.tensor(x), lp, seq_len=S, heads=H, mask_len=mask_len, interior=interior)
    _assert_q8_close(got.numpy(), want)
    plain = P.attn_q8_variant_plain(torch.tensor(x), lp, seq_len=S, heads=H, mask_len=mask_len, interior=interior)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("gelu,requant", [(True, True), (True, False), (False, False), (False, True)])
def test_mlp_q8_diag_matches_the_jax_script(jscript, rng, gelu, requant):
    lp = _layer_plan(rng)
    x = rng.standard_normal((64, W)).astype(np.float32)
    want = jscript.mlp_q8_diag(jnp.asarray(x), _jlp(lp), tile=64, gelu=gelu, requant=requant)
    got = P.mlp_q8_diag(torch.tensor(x), lp, gelu=gelu, requant=requant)
    _assert_q8_close(got.numpy(), want)
    assert torch.equal(got, P.mlp_q8_diag_plain(torch.tensor(x), lp, gelu=gelu, requant=requant))


def test_production_settings_are_the_block_kernels(rng):
    """Interior 0 is B4a and gelu = requant = 1 is B4b, bit for bit."""
    lp = _layer_plan(rng)
    x = torch.tensor(rng.standard_normal((4 * S, W)).astype(np.float32))
    kw = dict(seq_len=S, heads=H, mask_len=13, causal=False)
    assert torch.equal(
        P.attn_q8_variant(x, lp, interior=P.INTERIOR_PRODUCTION, **kw),
        T.fused_attention_block_q8(x, *P.attn_operands(lp), **kw),
    )
    assert torch.equal(P.mlp_q8_diag(x, lp, gelu=True, requant=True), T.fused_mlp_block_q8(x, *P.mlp_operands(lp)))


def test_diagnostics_differ_from_production(rng):
    """The switches do switch: no-gelu and no-requant change the numbers,
    and the no-max softmax stays a softmax (close to production here, where
    the logits are small)."""
    lp = _layer_plan(rng)
    x = torch.tensor(rng.standard_normal((4 * S, W)).astype(np.float32))
    prod = P.mlp_q8_diag(x, lp, gelu=True, requant=True)
    no_rq = P.mlp_q8_diag(x, lp, gelu=True, requant=False)
    no_gelu = P.mlp_q8_diag(x, lp, gelu=False, requant=False)
    assert not torch.equal(prod, no_rq) and not torch.equal(no_rq, no_gelu)
    np.testing.assert_allclose(no_rq.numpy(), prod.numpy(), atol=0.05)  # quantization noise only
    assert (no_gelu - prod).abs().max() > 0.05
    kw = dict(seq_len=S, heads=H, mask_len=S)
    a0 = P.attn_q8_variant(x, lp, interior=P.INTERIOR_PRODUCTION, **kw)
    a1 = P.attn_q8_variant(x, lp, interior=P.INTERIOR_NOMAX, **kw)
    np.testing.assert_allclose(a1.numpy(), a0.numpy(), atol=QUANT_STEP_ATOL)


def test_argument_checks(rng):
    lp = _layer_plan(rng)
    x = torch.zeros(2 * S, W)
    with pytest.raises(ValueError, match="interior"):
        P.attn_q8_variant(x, lp, seq_len=S, heads=H, mask_len=S, interior=2)
    with pytest.raises(ValueError, match="whole sequences"):
        P.attn_q8_variant(torch.zeros(S + 1, W), lp, seq_len=S, heads=H, mask_len=S, interior=0)
    with pytest.raises(ValueError, match="chunks"):
        P.mlp_q8_diag(x, lp, gelu=True, requant=True, n_chunks=3)
    with pytest.raises(ValueError, match="x must be"):
        P.mlp_q8_diag(torch.zeros(S, W + 1), lp, gelu=True, requant=True)
    dispatch.reset_launch_counts()
    P.mlp_q8_diag(x, lp, gelu=True, requant=True)
    counts = dispatch.launch_counts()
    assert counts["attn_q8_variant"] == 0 and counts["mlp_q8_diag"] == 0  # the CPU route launches nothing


def test_main_prints_the_seven_lines(monkeypatch, capsys):
    """``main`` on the CPU at a tiny arch put under the ViT-L/14 name: the
    control flow of the profiler, not a measurement."""
    tiny = TM.CLIPArch(
        embed_dim=64, image_resolution=32, vision_layers=1, vision_width=128, vision_patch_size=8,
        context_length=16, vocab_size=512, text_width=128, text_heads=2, text_layers=1,
    )
    monkeypatch.setitem(TM.ARCHS, "ViT-L/14", tiny)
    medians = P.main(["--batch", "2", "--iters", "1", "--reps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("device cpu")
    labels = [ln.split(" median ")[0].strip() for ln in out[1:]]
    assert labels == list(medians) and len(labels) == 7
    assert labels[0].startswith("attn_q8") and labels[2].startswith("mlp_q8") and labels[-1].endswith("(B1)")
    assert all(np.isfinite(v) and v > 0 for v in medians.values())


def test_main_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.main(["--device", "cuda"])
