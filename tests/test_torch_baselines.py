"""The port's text-only baselines held to the JAX package's.

JAX ``tests/test_text_baselines.py``'s six cases run against both packages
(the port on the CPU), and both packages score the same seeded variant
texts. The rank is ``1 + #{j : s_ij > best_i}``, a strict comparison, and
a numpy product (JAX side) and a torch product (port side) round
differently, so a query with other artifacts' candidates within 1e-5 (or,
where wider, twice the f32 rounding bound of the dot product, 2 x D x
2^-24) of its best same-artifact candidate (a near tie, counted on an f64
product, equal values included) may move by as many ranks as there are
candidates in that window. Metrics agree to 1e-4 plus, per near-tie query, its whole
share of a Recall@K or the MRR (100 / N), and its window's size over N
for the mean rank. ``HashTextEncoder`` repeats four digest bytes across
its dims, so such ties are common; identical texts embed identically.
"""

import json
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest

from knowledge_enhanced_multimodal_retrieval_tpu.baselines import text_models as JT
from knowledge_enhanced_multimodal_retrieval_tpu_torch.baselines import text_models as TT

NEAR_TIE = 1e-5


def near_tie(dim):
    """The tie window: 1e-5, or twice the f32 rounding bound of a ``dim``-d
    dot product of unit rows (``dim`` x 2^-24 each) where that is wider."""
    return max(NEAR_TIE, 2 * dim * 2.0 ** -24)


def _api(pkg):
    if pkg == "jax":
        return SimpleNamespace(grouped=JT.grouped_retrieval_metrics, evaluate=JT.evaluate_text_model,
                               load=JT.load_text_variants, lm=JT.evaluate_lm_query_target, Hash=JT.HashTextEncoder)
    return SimpleNamespace(grouped=partial(TT.grouped_retrieval_metrics, device="cpu"),
                           evaluate=partial(TT.evaluate_text_model, device="cpu"), load=TT.load_text_variants,
                           lm=partial(TT.evaluate_lm_query_target, device="cpu"), Hash=TT.HashTextEncoder)


PKGS = ["jax", "port"]


def _np_reference_grouped(sim, col_to_group, ks=(1, 5, 10, 20)):
    """Oracle: the reference's per-row argsort walk (evaluate_text_models.py:193-224)."""
    ranks = []
    for i in range(sim.shape[0]):
        ranked_artifacts = col_to_group[np.argsort(-sim[i], kind="stable")]
        ranks.append(int(np.where(ranked_artifacts == i)[0][0]) + 1)
    ranks = np.array(ranks)
    out = {f"T2T_R@{k}": np.mean(ranks <= k) * 100 for k in ks}
    out["T2T_MRR"] = np.mean(1.0 / ranks) * 100
    out["T2T_Mean_Rank"] = np.mean(ranks)
    return out


@pytest.mark.parametrize("pkg", PKGS)
def test_grouped_metrics_match_argsort_oracle(rng, pkg):
    n, v = 16, 4
    sim = rng.standard_normal((n, n * v)).astype(np.float32)
    groups = np.repeat(np.arange(n), v)
    ours = _api(pkg).grouped(sim, groups)
    ref = _np_reference_grouped(sim, groups)
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-4), k


@pytest.mark.parametrize("pkg", PKGS)
def test_grouped_metrics_perfect_case(pkg):
    n, v = 6, 3
    sim = np.full((n, n * v), -1.0, np.float32)
    groups = np.repeat(np.arange(n), v)
    for i in range(n):
        sim[i, i * v] = 1.0
    m = _api(pkg).grouped(sim, groups, k_values=(1,))
    assert m["T2T_R@1"] == pytest.approx(100.0)
    assert m["T2T_MRR"] == 100.0


def _variants(n=12, v=5):
    return [[f"artifact{i} variant{j} common{i}" for j in range(v)] for i in range(n)]


@pytest.mark.parametrize("pkg", PKGS)
def test_single_and_multi_modes_run(pkg):
    api = _api(pkg)
    enc = api.Hash(dim=16)
    for m in (api.evaluate(enc, _variants(), mode="single"), api.evaluate(enc, _variants(), mode="multi")):
        assert set(m) == {"T2T_R@1", "T2T_R@5", "T2T_R@10", "T2T_R@20", "T2T_MRR", "T2T_Mean_Rank"}
        assert 0 <= m["T2T_MRR"] <= 100
    with pytest.raises(ValueError):
        api.evaluate(enc, _variants(), mode="nope")


@pytest.mark.parametrize("pkg", PKGS)
def test_identical_variants_rank_first(pkg):
    api = _api(pkg)
    texts = [[f"unique-artifact-{i}"] * 5 for i in range(10)]
    m = api.evaluate(api.Hash(dim=16), texts, mode="multi", k_values=(1,))
    assert m["T2T_R@1"] == pytest.approx(100.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_load_text_variants(tmp_path, pkg):
    api = _api(pkg)
    d = tmp_path / "texts"
    d.mkdir()
    (d / "u1.json").write_text(json.dumps({"content_descriptions": ["a", " ", "c"]}))
    out = api.load(["u1", "missing"], str(d), "content", num_variants=5)
    assert out[0] == ["a", "", "c", "", ""]
    assert out[1] == [""] * 5
    with pytest.raises(KeyError):
        api.load(["u1"], str(d), "bogus_type")


@pytest.mark.parametrize("pkg", PKGS)
def test_lm_query_target_baseline(pkg):
    api = _api(pkg)
    enc = api.Hash(dim=16)
    queries = [f"find the artifact number {i}" for i in range(12)]
    m = api.lm(enc, queries, list(queries))  # identical -> rank 1
    assert m["T2T_R@1"] == pytest.approx(100.0)
    m2 = api.lm(enc, queries, list(reversed(queries)), mrr_only=True)
    assert "T2T_R@1" not in m2 and "T2T_MRR" in m2
    with pytest.raises(ValueError):
        api.lm(enc, queries, queries[:-1])


# ---------------------------------------------------------------------------
# both packages on the same seeded inputs
# ---------------------------------------------------------------------------


def seeded_variants(n, v=5, seed=0, vocab=40, dup_every=7):
    """``n`` artifacts x ``v`` variants: an artifact word plus random words;
    every ``dup_every``-th artifact repeats one text in all its variants."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    out = []
    for i in range(n):
        if i % dup_every == 0:
            out.append([f"artifact {i} " + " ".join(rng.choice(words, 4))] * v)
            continue
        out.append([f"artifact {i} " + " ".join(rng.choice(words, rng.integers(2, 8))) for _ in range(v)])
    return out


def near_tie_queries(emb_by_variant, query_variant, exclude):
    """Queries whose best same-artifact candidate lies within NEAR_TIE of
    another candidate's score without equalling it (f64 products)."""
    e = [x.astype(np.float64) for x in emb_by_variant]
    n = e[0].shape[0]
    pool = np.stack([x for j, x in enumerate(e) if j != exclude], axis=1)  # [N, V-1, D]
    sim = e[query_variant] @ pool.reshape(-1, pool.shape[-1]).T
    own = np.repeat(np.arange(n), pool.shape[1])[None, :] == np.arange(n)[:, None]
    return _near(sim, np.where(own, sim, -np.inf).max(1), ~own, near_tie(pool.shape[-1]))


def _near(sim, best, others, window_width):
    """(queries with a near tie, candidates in their tie windows): the
    ``others`` within ``window_width`` of a query's best, f64 ties included
    (two f32 sums in another order can split them). A query moves by at most
    its window's size, a Recall@K or the MRR by its share."""
    window = ((np.abs(sim - best[:, None]) < window_width) & others).sum(1)
    return np.array([int((window > 0).sum()), int(window.sum())])


def assert_metrics_agree(got, want, n_queries, near):
    n_near, n_window = near
    assert got.keys() == want.keys()
    for key, v in want.items():
        bound = n_window if key.endswith("Mean_Rank") else 100.0 * n_near
        assert abs(got[key] - v) <= 1e-4 + bound / n_queries, (key, got[key], v, n_near)


@pytest.mark.parametrize("dim", [32, 768])
@pytest.mark.parametrize("mode", ["single", "multi"])
def test_port_equals_jax_on_seeded_variants(mode, dim):
    texts = seeded_variants(300, seed=dim)
    want = JT.evaluate_text_model(JT.HashTextEncoder(dim), texts, mode=mode)
    got = TT.evaluate_text_model(TT.HashTextEncoder(dim), texts, mode=mode, device="cpu")
    emb = [TT.HashTextEncoder(dim).encode([t[v] for t in texts]) for v in range(5)]
    roles = [0] if mode == "single" else range(5)
    n_near = sum(near_tie_queries(emb, v, v) for v in roles)  # summed element-wise
    assert_metrics_agree(got, want, len(texts) * len(roles), n_near)


def test_hash_encoder_is_the_same_function():
    texts = ["", "a", "a painting of a dog", "ωμέγα", "x" * 300]
    for dim in (16, 32, 768):
        np.testing.assert_array_equal(TT.HashTextEncoder(dim).encode(texts), JT.HashTextEncoder(dim).encode(texts))


def test_lm_query_target_equals_jax():
    texts = seeded_variants(200, seed=3)
    queries, targets = [t[0] for t in texts], [t[1] for t in texts]
    enc = TT.HashTextEncoder(64)
    sim = enc.encode(queries).astype(np.float64) @ enc.encode(targets).astype(np.float64).T
    n_near = _near(sim, np.diagonal(sim), ~np.eye(len(queries), dtype=bool), near_tie(64))
    for mrr_only in (False, True):
        want = JT.evaluate_lm_query_target(JT.HashTextEncoder(64), queries, targets, mrr_only=mrr_only)
        got = TT.evaluate_lm_query_target(TT.HashTextEncoder(64), queries, targets, mrr_only=mrr_only, device="cpu")
        assert_metrics_agree(got, want, len(queries), n_near)
