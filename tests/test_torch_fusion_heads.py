"""The port's six fusion heads and their trainer, held to the JAX package.

Heads carry a flax head's parameters across (``fusion_params_from_flax``)
and must give its scores; the head artifact reads in both directions; the
trainer follows the JAX trainer step for step on the heads without dropout
and learns on the others.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from knowledge_enhanced_multimodal_retrieval_tpu.eval.evaluator import EncodedDataset as JEnc
from knowledge_enhanced_multimodal_retrieval_tpu.models.fusion_heads import FusionModel as JFM
from knowledge_enhanced_multimodal_retrieval_tpu.train import fusion_trainer as JT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.eval.evaluator import EncodedDataset as TEnc
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import fusion_heads as FH
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models.fusion_heads import FusionModel as TFM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import fusion_trainer as TT

D = 16
TOL = {"cross_attention": dict(rtol=1e-4, atol=1e-5)}
DEFAULT_TOL = dict(rtol=1e-5, atol=1e-6)
DROPOUT_FREE = ("simple_gated", "simple_gated_with_bias", "bilinear")


def _norm(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _flat(params):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}


@pytest.fixture(scope="module")
def embeds():
    rng = np.random.default_rng(5)
    return _norm(rng.standard_normal((6, D))), _norm(rng.standard_normal((9, D))), _norm(rng.standard_normal((9, D)))


@pytest.fixture(scope="module")
def encoded():
    """T2I informative, T2T noise: a trained head should favour T2I."""
    rng = np.random.default_rng(7)
    n = 64
    base = rng.standard_normal((n, D)).astype(np.float32)
    query = _norm(base + 0.1 * rng.standard_normal((n, D)))
    image = _norm(base + 0.1 * rng.standard_normal((n, D)))
    target = _norm(rng.standard_normal((n, D)))
    return image, query, target, [f"u{i}" for i in range(n)]


def _pair(fusion_type, key=1):
    jf = JFM(fusion_type, D)
    params = jf.init(jax.random.PRNGKey(key))
    tf = TFM(fusion_type, D)
    return jf, params, tf, tf.from_flax(_flat(params))


@pytest.mark.parametrize("fusion_type", FH.FUSION_TYPES)
def test_heads_match_jax_with_carried_params(embeds, fusion_type):
    jf, params, tf, head = _pair(fusion_type)
    q, i, t = embeds
    tol = TOL.get(fusion_type, DEFAULT_TOL)
    want = np.asarray(jf.scores(params, jnp.asarray(q), jnp.asarray(i), jnp.asarray(t)))
    with torch.no_grad():
        got = tf.scores(head, *map(torch.as_tensor, (q, i, t))).numpy()
    np.testing.assert_allclose(got, want, **tol)
    want_b = np.asarray(jf.blockwise_scores(params, jnp.asarray(q), jnp.asarray(i), jnp.asarray(t), block_q=4, block_c=4))
    got_b = tf.blockwise_scores(head, *map(torch.as_tensor, (q, i, t)), block_q=4, block_c=4).numpy()
    np.testing.assert_allclose(got_b, want_b, **tol)
    cand = np.stack([np.random.default_rng(r).permutation(9)[:5] for r in range(6)])
    want_c = np.asarray(jf.candidate_scores(params, jnp.asarray(q), jnp.asarray(i[cand]), jnp.asarray(t[cand])))
    got_c = tf.candidate_scores(head, torch.as_tensor(q), torch.as_tensor(i[cand]), torch.as_tensor(t[cand])).numpy()
    np.testing.assert_allclose(got_c, want_c, **tol)
    # one batched call == each query's one-row scores over its own candidates
    for r in range(6):
        one = tf.scores(head, torch.as_tensor(q[r : r + 1]), torch.as_tensor(i[cand[r]]), torch.as_tensor(t[cand[r]]))
        np.testing.assert_allclose(got_c[r], one.detach().numpy()[0], rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("fusion_type", FH.FUSION_TYPES)
def test_params_carry_across_both_ways(fusion_type):
    _, params, tf, head = _pair(fusion_type, key=4)
    flat = _flat(params)
    back = FH.fusion_params_to_flax(FH.head_state_numpy(head))
    assert list(back) == list(flat)  # flax's key order
    for k in flat:
        assert back[k].shape == flat[k].shape and np.array_equal(back[k], flat[k]), k
    # a fresh port head has the JAX head's parameter shapes
    fresh = FH.fusion_params_to_flax(FH.head_state_numpy(tf.init(0)))
    assert {k: v.shape for k, v in fresh.items()} == {k: v.shape for k, v in flat.items()}


def test_fixed_inits_match_jax():
    for fusion_type, fixed in (("simple_gated", {"query_weight": np.ones(D), "bias": np.zeros(1)}),
                               ("simple_gated_with_bias", {"query_weight": np.zeros(D), "bias": np.float32(-2.0)}),
                               ("bilinear", {"alpha": np.float32(0.5)})):
        got = FH.fusion_params_to_flax(FH.head_state_numpy(TFM(fusion_type, D).init(3)))
        want = _flat(JFM(fusion_type, D).init(jax.random.PRNGKey(3)))
        for k, v in fixed.items():
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], v)


def test_dense_init_is_flax_lecun_normal():
    """Truncated at 2 sigma, std sqrt(1 / fan_in) after the truncation, zero
    biases, drawn from the explicit generator (the global RNG is not read)."""
    torch.manual_seed(123)
    a = FH.head_state_numpy(TFM("cross_attention", 64).init(torch.Generator().manual_seed(9)))
    torch.manual_seed(456)
    b = FH.head_state_numpy(TFM("cross_attention", 64).init(9))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    w = a["mlp1.weight"]  # [256, 64], fan-in 64
    std = np.sqrt(1.0 / 64)
    assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-6
    assert w.std() == pytest.approx(std, rel=0.05)
    assert not a["mlp1.bias"].any() and not a["cross_attn.query.bias"].any()


def test_dropout_draws_from_the_explicit_generator(embeds):
    q, i, t = map(torch.as_tensor, embeds)
    tf = TFM("cross_attention", D)
    head = tf.init(0)
    det = tf.scores(head, q, i, t)
    assert torch.equal(det, tf.scores(head, q, i, t, deterministic=True, generator=torch.Generator().manual_seed(1)))
    torch.manual_seed(1)
    x = tf.scores(head, q, i, t, deterministic=False, generator=torch.Generator().manual_seed(2))
    torch.manual_seed(99)
    y = tf.scores(head, q, i, t, deterministic=False, generator=torch.Generator().manual_seed(2))
    assert torch.equal(x, y) and not torch.equal(x, det)


def test_head_artifact_reads_both_ways(tmp_path, embeds):
    q, i, t = embeds
    for fusion_type in FH.FUSION_TYPES:
        jf, params, tf, head = _pair(fusion_type, key=6)
        jpath, tpath = str(tmp_path / f"j_{fusion_type}.npz"), str(tmp_path / f"t_{fusion_type}.npz")
        JT.save_fusion_head(jpath, jf, params)
        TT.save_fusion_head(tpath, tf, head)
        with np.load(jpath) as zj, np.load(tpath) as zt:
            assert zt.files == zj.files
            for k in zj.files:
                assert zt[k].dtype == zj[k].dtype and np.array_equal(zt[k], zj[k]), k
        fm_t, head_t = TT.load_fusion_head(jpath, device="cpu")  # JAX-written, port-served
        fm_j, params_j = JT.load_fusion_head(tpath)  # port-written, JAX-served
        assert fm_t.fusion_type == fm_j.fusion_type == fusion_type and fm_t.embed_dim == fm_j.embed_dim == D
        want = np.asarray(fm_j.scores(params_j, jnp.asarray(q), jnp.asarray(i), jnp.asarray(t)))
        with torch.no_grad():
            got = fm_t.scores(head_t, *map(torch.as_tensor, (q, i, t))).numpy()
        np.testing.assert_allclose(got, want, **TOL.get(fusion_type, DEFAULT_TOL))


@pytest.mark.parametrize("fusion_type", DROPOUT_FREE)
def test_trainer_follows_the_jax_trainer(encoded, fusion_type):
    image, query, target, uuids = encoded
    jf, params, tf, head = _pair(fusion_type, key=3)
    jp, jh = JT.train_fusion_head(jf, JEnc(image, query, target, uuids), epochs=3, batch_size=24, lr=5e-2,
                                  params=params)
    tp, th = TT.train_fusion_head(tf, TEnc(image, query, target, uuids), epochs=3, batch_size=24, lr=5e-2,
                                  params=head, device="cpu")
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-4)
    got, want = FH.fusion_params_to_flax(FH.head_state_numpy(tp)), _flat(jp)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    jr = JT.evaluate_fusion_model(jf, jp, JEnc(image, query, target, uuids), block_q=16, block_c=32)
    tr = TT.evaluate_fusion_model(tf, tp, TEnc(image, query, target, uuids), block_q=16, block_c=32)
    assert set(tr) == set(jr) and set(tr["score_stats"]) == set(jr["score_stats"])
    for part in ("fusion", "baseline", "score_stats"):
        for k, v in jr[part].items():
            assert tr[part][k] == pytest.approx(v, rel=1e-4, abs=1e-5), (part, k)


@pytest.mark.parametrize("fusion_type", ["linear", "cross_attention", "gated", "simple_gated_with_bias"])
def test_train_reduces_loss_and_beats_init(encoded, fusion_type):
    image, query, target, uuids = encoded
    enc = TEnc(image, query, target, uuids)
    fm = TFM(fusion_type, D)
    init = TT.evaluate_fusion_model(fm, fm.init(0), enc, block_q=16, block_c=32)
    head, history = TT.train_fusion_head(fm, enc, epochs=30, batch_size=32, lr=5e-2, seed=0, device="cpu")
    assert history["loss"][-1] < history["loss"][0]
    report = TT.evaluate_fusion_model(fm, head, enc, block_q=16, block_c=32)
    assert report["fusion"]["FUSION_MRR"] > init["fusion"]["FUSION_MRR"]
    assert set(report["score_stats"]) == {"fused_mean", "fused_std", "baseline_mean", "baseline_std"}


def test_unknown_type_raises():
    with pytest.raises(ValueError, match="Unknown fusion type"):
        TFM("nope", D)
    with pytest.raises(ValueError, match="Unknown fusion type"):
        FH.build_head("nope")
