"""The port's contrastive losses held to the JAX package's (and InfoNCE to
the reference's torch formulation), every metric key, at rtol / atol 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from knowledge_enhanced_multimodal_retrieval_tpu.train import losses as JL
from knowledge_enhanced_multimodal_retrieval_tpu.utils.config import TrainConfig as JCfg
from knowledge_enhanced_multimodal_retrieval_tpu_torch.train import losses as TL
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import TrainConfig as TCfg

@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes: one intra-op thread (the lane runs six workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _feats(rng, n=16, d=32):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _same(got, want):
    loss_t, m_t = got
    loss_j, m_j = want
    assert set(m_t) == set(m_j), (sorted(m_t), sorted(m_j))
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-4, abs=1e-4)
    for k in m_j:
        assert float(m_t[k]) == pytest.approx(float(m_j[k]), rel=1e-4, abs=1e-4), k


def _both(fn_t, fn_j, arrays, **kw):
    t = fn_t(*(None if a is None else torch.from_numpy(a) for a in arrays[:3]),
             **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    j = fn_j(*(None if a is None else jnp.asarray(a) for a in arrays[:3]),
             **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    return t, j


def test_info_nce_matches_the_reference_torch_formulation(rng):
    a, b = _feats(rng), _feats(rng)
    loss, metrics = TL.info_nce(torch.from_numpy(a), torch.from_numpy(b), temperature=0.07)
    logits = torch.from_numpy(a) @ torch.from_numpy(b).T / 0.07
    labels = torch.arange(16)
    ref = (F.cross_entropy(logits, labels) + F.cross_entropy(logits.T, labels)) / 2
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)
    assert set(metrics) == {"loss", "loss_a2b", "loss_b2a"}


@pytest.mark.parametrize("negs", [None, "a", "b", "ab"])
@pytest.mark.parametrize("pair", ["info_nce", "sigmoid_contrastive"])
def test_pair_losses_match_jax(rng, pair, negs):
    a, b = _feats(rng), _feats(rng)
    kw = {}
    if negs and "a" in negs:
        kw["negatives_a"] = _feats(rng, n=5)
    if negs and "b" in negs:
        kw["negatives_b"] = _feats(rng, n=7)
    _same(*_both(getattr(TL, pair), getattr(JL, pair), (a, b), temperature=0.1, **kw))


@pytest.mark.parametrize("with_negs", [False, True])
@pytest.mark.parametrize("joint", ["joint_contrastive_loss", "joint_sigmoid_loss"])
def test_joint_losses_match_jax(rng, joint, with_negs):
    img, q, t = _feats(rng), _feats(rng), _feats(rng)
    kw = dict(temperature=0.07, t2i_weight=0.7, t2t_weight=0.3)
    if with_negs:
        kw["neg_text_features"] = _feats(rng, n=6)
    _same(*_both(getattr(TL, joint), getattr(JL, joint), (img, q, t), **kw))


@pytest.mark.parametrize("loss", ["infonce", "siglip"])
@pytest.mark.parametrize("dims", [(), (8,), (8, 16)])
def test_loss_for_config_matches_jax(rng, loss, dims):
    """Matryoshka at one and two prefixes (the full width appended), both objectives."""
    img, q, t = _feats(rng), _feats(rng), _feats(rng)
    kw = dict(loss=loss, matryoshka_dims=dims, sigmoid_bias=-5.0)
    fn_t, fn_j = TL.joint_loss_for_config(TCfg(**kw)), JL.joint_loss_for_config(JCfg(**kw))
    for negs in (None, _feats(rng, n=4)):
        extra = {} if negs is None else {"neg_text_features": negs}
        got, want = _both(fn_t, fn_j, (img, q, t), temperature=0.1, t2i_weight=0.6, t2t_weight=0.4, **extra)
        _same(got, want)
        if dims:
            assert {f"loss_d{d}" for d in (*dims, 32)} <= set(got[1])


def test_matryoshka_refuses_bad_dims(rng):
    with pytest.raises(ValueError, match="positive"):
        TL.matryoshka_joint_loss(TL.joint_contrastive_loss, (0,))
    fn = TL.matryoshka_joint_loss(TL.joint_contrastive_loss, (64,))
    x = torch.from_numpy(_feats(rng))
    with pytest.raises(ValueError, match="exceed"):
        fn(x, x, x)
    with pytest.raises(ValueError, match="infonce"):
        TL.joint_loss_for_config(TCfg(loss="hinge"))


@pytest.mark.parametrize("pair", ["info_nce", "sigmoid_contrastive"])
@pytest.mark.parametrize("axis", [None, "data"])
def test_axis_name_is_one_process(rng, pair, axis):
    """Sharded features ``[S, B, D]``: each shard's loss as the JAX
    ``shard_map`` body computes it over S devices (its own rows, or with
    ``axis_name`` against every shard's gathered columns, labels offset by
    the shard's first row; mined negatives gathered like the batch), the
    shards' mean as ``pmean``. On one process ``axis_name`` over ``[B, D]``
    gathers nothing."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    a, b, neg = _feats(rng), _feats(rng), _feats(rng, n=8)
    fn_t, fn_j = getattr(TL, pair), getattr(JL, pair)
    two = torch.from_numpy(a), torch.from_numpy(b)
    assert float(fn_t(*two, axis_name="data")[0]) == float(fn_t(*two)[0])
    mesh = Mesh(np.array(jax.devices()[:4]), ("data",))

    def body(x, y, n):
        loss, m = fn_j(x, y, axis_name=axis, negatives_b=n)
        return jax.lax.pmean(loss, "data")

    want = jax.shard_map(body, mesh=mesh, in_specs=(P("data"), P("data"), P("data")), out_specs=P(),
                         check_vma=False)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(neg))
    shard = lambda x: torch.from_numpy(x).reshape(4, -1, x.shape[-1])  # noqa: E731
    got, _ = fn_t(shard(a), shard(b), axis_name=axis, negatives_b=shard(neg))
    assert float(got) == pytest.approx(float(want), rel=1e-5, abs=1e-6)
