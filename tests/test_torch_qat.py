"""The port's QAT (``train.qat``) held to the JAX package's.

The fake quantizations are bit-equal to JAX in f32 (the weight's
per-output-channel axis is dim 1 of the port's ``[out, in]`` layout) with
identity gradients; a QAT forward of the tiny CLIP matches ``qat_apply``,
only the four block projections change, and three QAT train steps match
the JAX trainer's (loss, ``grad_norm``, every parameter) at rtol / atol 1e-4.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.train import qat as JQ
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.convert import openai_state_dict
from knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts import qat_payoff
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import qat as TQ
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import trainer as TT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig as TCfg
from tests.test_torch_train import TOL, assert_same_params, jax_openai, port_model, run_both, world  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread (the lane runs six workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(24, 16), (96, 32), (5, 7)])
def test_fake_quant_weight_bit_equal(shape):
    """flax ``[in, out]`` kernel through JAX == its ``[out, in]`` transpose through the port."""
    w = np.random.default_rng(shape[0]).standard_normal(shape).astype(np.float32) * 0.3
    want = np.asarray(JQ.fake_quant_weight(jnp.asarray(w)))
    got = TQ.fake_quant_weight(torch.from_numpy(w.T.copy())).numpy().T
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(6, 32), (3, 5, 64), (1, 7)])
def test_fake_quant_rows_bit_equal(shape):
    x = np.random.default_rng(len(shape)).standard_normal(shape).astype(np.float32) * 2.0
    x.reshape(-1)[0] = 0.0
    np.testing.assert_array_equal(TQ.fake_quant_rows(torch.from_numpy(x)).numpy(),
                                  np.asarray(JQ.fake_quant_rows(jnp.asarray(x))))


def test_fake_quant_rows_zero_row_stays_zero():
    x = torch.zeros(2, 8)
    assert torch.equal(TQ.fake_quant_rows(x), x)


def test_straight_through_gradients():
    w = torch.randn(8, 4, generator=torch.Generator().manual_seed(2), requires_grad=True)
    TQ.fake_quant_weight(w).sum().backward()
    assert torch.equal(w.grad, torch.ones_like(w))
    w.grad = None
    (TQ.fake_quant_rows(w) * 3.0).sum().backward()
    assert torch.allclose(w.grad, torch.full_like(w, 3.0))


def test_qat_params_touch_only_block_projections(world):
    arch, params, *_ = world
    named = dict(port_model(arch, params).named_parameters())
    q = TQ.qat_params(named)
    changed = {n for n in named if not torch.equal(q[n], named[n])}
    assert changed == {n for n in named if TQ.is_qat_weight(n)}
    assert all(n.endswith(TQ.QAT_WEIGHT_NAMES) for n in changed) and len(changed) == 8  # 4 a tower, 1 layer each


@pytest.mark.parametrize("method", ["encode_image", "encode_text"])
def test_qat_forward_matches_qat_apply(world, method):
    arch, params, _, _, batches = world
    b = batches[0]
    x = b.images if method == "encode_image" else b.query_ids
    jmodel = JM.CLIP(arch, dtype=jnp.float32)
    want = JQ.qat_apply(jmodel, params, jnp.asarray(x), method=getattr(JM.CLIP, method))
    plain = jmodel.apply({"params": params}, jnp.asarray(x), method=getattr(JM.CLIP, method))
    model = port_model(arch, params)
    fwd = TT.forward_for_config(model, TCfg(qat=True))
    with torch.no_grad():
        got = fwd(method, torch.from_numpy(x))
        again = getattr(model, method)(torch.from_numpy(x))  # the hook is gone after the call
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(again.numpy(), np.asarray(plain), **TOL)
    assert float(np.abs(np.asarray(want) - np.asarray(plain)).max()) > 1e-4  # QAT moved the forward


@pytest.mark.parametrize("case", ["qat", "qat_remat"])
def test_qat_steps_match_jax(world, tmp_path, case):
    jm, tm, jstate, tt = run_both(world, tmp_path, qat=True, remat=case == "qat_remat")
    for i, (j, t) in enumerate(zip(jm, tm)):
        for key in ("loss", "loss_t2i", "loss_t2t", "grad_norm"):
            assert t[key] == pytest.approx(j[key], rel=1e-4, abs=1e-4), (i, key, t[key], j[key])
    assert_same_params(openai_state_dict(tt.model), jax_openai(jstate["params"]))
    # master weights stay full precision (not snapped to their rounding points)
    w = tt.model.text.transformer.resblocks[0].mlp.c_fc.weight.detach()
    assert not torch.equal(TQ.fake_quant_weight(w), w)
    assert all(m.projection_hook is None for m in tt.model.modules() if hasattr(m, "projection_hook"))


def test_qat_payoff_quick_reports_the_jax_keys(tmp_path):
    """``scripts.qat_payoff --quick --device=cpu``: both runs train and deploy
    through the int8 plans' plain versions; the keys of the JAX script's
    record (``QAT_PAYOFF.json``, written on the CPU by the JAX script)."""
    out = qat_payoff.main(["--quick", "--device=cpu", "--out", str(tmp_path / "qp.json")])
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "QAT_PAYOFF.json")) as f:
        record = json.load(f)
    assert set(record) <= set(out) and set(out["delta_qat_minus_ptq"]) == set(record["delta_qat_minus_ptq"])
    for run in ("ptq", "qat"):
        assert set(out["runs"][run]) == set(record["runs"][run])
        assert out["runs"][run]["steps"] == 2 * (48 // 16)
        assert all(np.isfinite(v) for v in out["runs"][run].values())
    assert out["config"] == {"pairs": 48, "epochs": 2, "batch": 16, "lr": 2e-3} and out["backend"] == "cpu"
    assert json.loads((tmp_path / "qp.json").read_text()) == out
