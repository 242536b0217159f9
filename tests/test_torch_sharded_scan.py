"""The port's sharded corpus scans, held to the JAX package's on the CPU.

Every ``sharded_*`` function of ``ops.similarity``, ``ops.pq``,
``ops.binary_sketch`` and ``retrieval.ann`` over ``[cpu] * n`` against the
JAX function over the conftest's first ``n`` virtual devices, at 2, 4 and 8
shards, on the same seeded inputs: k below and above the rows a shard holds,
a scalar and a per-query alpha, ``[N]`` and ``[Q, N]`` masks. The tolerances
are the slice rule's: equal rows where there are no ties, values to rtol
1e-5. The sketch proxies tie by design; at a power-of-two width with alphas
in quarters every f32 product and sum is exact in both packages, so their
tie order is held too. Sharded IVF at nprobe = nlist equals brute force.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.ops import binary_sketch as JB
from knowledge_enhanced_multimodal_retrieval_tpu.ops import pq as JP
from knowledge_enhanced_multimodal_retrieval_tpu.ops import similarity as JS
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import make_mesh as jmake_mesh
from knowledge_enhanced_multimodal_retrieval_tpu.retrieval import ann as JA
from knowledge_enhanced_multimodal_retrieval_tpu.utils.config import MeshConfig as JMeshConfig
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import binary_sketch as TB
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import pq as TP
from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import similarity as TS
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import make_mesh
from knowledge_enhanced_multimodal_retrieval_tpu_torch.retrieval import ann as TA
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig

N, D, Q = 96, 16, 7  # 96 rows: 48 / 24 / 12 a shard at 2 / 4 / 8 shards
SHARDS = (2, 4, 8)
KS = (7, 30)  # below every shard's rows, and above the 8- and 4-shard ones
TOL = 1e-5


def _meshes(devices8, n):
    return (jmake_mesh(JMeshConfig(data_parallel=n), devices=devices8[:n]),
            make_mesh(MeshConfig(data_parallel=n), [torch.device("cpu")] * n))


def _norm(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    img, txt = _norm(rng.standard_normal((N, D))), _norm(rng.standard_normal((N, D)))
    q = _norm(rng.standard_normal((Q, D)))
    return dict(img=img, txt=txt, q=q, alpha=rng.uniform(0.1, 0.9, Q).astype(np.float32),
                mask1=rng.random(N) < 0.4, mask2=rng.random((Q, N)) < 0.3, rng=rng)


def _alpha(data, per_query):
    return data["alpha"] if per_query else 0.3


def _same(jout, tout, tol=TOL, exact_rows=True):
    jv, ji = (np.asarray(a) for a in jout)
    tv, ti = (a.numpy() for a in tout)
    assert tv.shape == jv.shape and ti.shape == ji.shape
    np.testing.assert_allclose(tv, jv, rtol=tol, atol=tol)
    if exact_rows:
        np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("per_query", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_exact_matches_jax(devices8, data, n, k, per_query):
    jm, tm = _meshes(devices8, n)
    a = _alpha(data, per_query)
    j = JS.sharded_similarity_topk(jnp.asarray(data["q"]), jnp.asarray(data["img"]), jnp.asarray(data["txt"]),
                                   k, jnp.asarray(a), jm)
    t = TS.sharded_similarity_topk(torch.tensor(data["q"]), torch.tensor(data["img"]), torch.tensor(data["txt"]),
                                   k, torch.tensor(a), tm)
    _same(j, t)
    # and the one-device scan
    _same(TS.fused_similarity_topk(torch.tensor(data["q"]), torch.tensor(data["img"]), torch.tensor(data["txt"]),
                                   k, torch.tensor(a)), t)


@pytest.mark.parametrize("mode", ["q8", "q4"])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_packed_matches_jax(devices8, data, n, k, mode):
    jm, tm = _meshes(devices8, n)
    quant = TS.quantize_corpus_host if mode == "q8" else TS.quantize_corpus_host_q4
    (ci, si), (ct, st) = quant(data["img"]), quant(data["txt"])
    jfn = JS.sharded_similarity_topk_q8 if mode == "q8" else JS.sharded_similarity_topk_q4
    tfn = TS.sharded_similarity_topk_q8 if mode == "q8" else TS.sharded_similarity_topk_q4
    a = data["alpha"]
    j = jfn(jnp.asarray(data["q"]), *(jnp.asarray(x) for x in (ci, si, ct, st)), k, jnp.asarray(a), jm)
    t = tfn(torch.tensor(data["q"]), *(torch.tensor(x) for x in (ci, si, ct, st)), k, torch.tensor(a), tm)
    _same(j, t)


@pytest.mark.parametrize("mask_kind", ["mask1", "mask2"])
@pytest.mark.parametrize("mode", ["exact", "q8", "q4"])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_masked_matches_jax(devices8, data, n, mode, mask_kind):
    jm, tm = _meshes(devices8, n)
    if mode == "exact":
        args = (data["img"], data["txt"])
    else:
        quant = TS.quantize_corpus_host if mode == "q8" else TS.quantize_corpus_host_q4
        (ci, si), (ct, st) = quant(data["img"]), quant(data["txt"])
        args = (ci, si, ct, st)
    mask = data[mask_kind]
    for k in KS + (60,):  # 60: more than some queries' eligible rows (the -1 sentinel)
        j = JS.sharded_masked_similarity_topk(jnp.asarray(data["q"]), tuple(jnp.asarray(x) for x in args),
                                              jnp.asarray(mask), k, jnp.asarray(data["alpha"]), jm, mode=mode)
        t = TS.sharded_masked_similarity_topk(torch.tensor(data["q"]), tuple(torch.tensor(x) for x in args),
                                              torch.tensor(mask), k, torch.tensor(data["alpha"]), tm, mode=mode)
        _same(j, t)
        live = np.asarray(j[1]) >= 0
        np.testing.assert_array_equal(t[1].numpy() >= 0, live)


@pytest.fixture(scope="module")
def pq_data(data):
    m = 4
    cb_i = TP.train_pq_codebooks(data["img"], m=m)
    cb_t = TP.train_pq_codebooks(data["txt"], m=m)
    ci, si = TP.pack_pq_host(data["img"], cb_i)
    ct, st = TP.pack_pq_host(data["txt"], cb_t)
    return ci, si, ct, st, cb_i, cb_t


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_pq_matches_jax(devices8, data, pq_data, n, k):
    jm, tm = _meshes(devices8, n)
    j = JP.sharded_pq_similarity_topk(jnp.asarray(data["q"]), *(jnp.asarray(x) for x in pq_data), k,
                                      jnp.asarray(data["alpha"]), jm)
    t = TP.sharded_pq_similarity_topk(torch.tensor(data["q"]), *(torch.tensor(x) for x in pq_data), k,
                                      torch.tensor(data["alpha"]), tm)
    _same(j, t)
    for mask_kind in ("mask1", "mask2"):
        mask = data[mask_kind]
        j = JP.sharded_masked_pq_similarity_topk(jnp.asarray(data["q"]), *(jnp.asarray(x) for x in pq_data),
                                                 jnp.asarray(mask), k, jnp.asarray(data["alpha"]), jm)
        t = TP.sharded_masked_pq_similarity_topk(torch.tensor(data["q"]), *(torch.tensor(x) for x in pq_data),
                                                 torch.tensor(mask), k, torch.tensor(data["alpha"]), tm)
        _same(j, t)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_hamming_matches_jax(devices8, data, n, k):
    """Width 64 and alphas in quarters: every proxy, product and sum is exact
    in f32, so the packages agree bit for bit, ties and their order included."""
    rng = np.random.default_rng(3)
    d = 64
    img, txt = _norm(rng.standard_normal((N, d))), _norm(rng.standard_normal((N, d)))
    q = _norm(rng.standard_normal((Q, d)))
    alpha = rng.choice([0.25, 0.5, 0.75], Q).astype(np.float32)
    bi, bt = TB.pack_sign_bits_host(img), TB.pack_sign_bits_host(txt)
    jm, tm = _meshes(devices8, n)
    j = JB.sharded_hamming_topk(jnp.asarray(q), jnp.asarray(bi), jnp.asarray(bt), dim=d, k=k,
                                alpha=jnp.asarray(alpha), mesh=jm)
    t = TB.sharded_hamming_topk(torch.tensor(q), torch.from_numpy(bi.view(np.int32)),
                                torch.from_numpy(bt.view(np.int32)), dim=d, k=k, alpha=torch.tensor(alpha), mesh=tm)
    _same(j, t, tol=0)


def _jax_index(index):
    """The port's index as the JAX package's ``IVFIndex`` (same arrays)."""
    arr = lambda t: None if t is None else jnp.asarray(t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy())  # noqa: E731
    return JA.IVFIndex(arr(index.centroids_img), arr(index.centroids_txt), arr(index.packed_img),
                       arr(index.packed_txt), arr(index.packed_rows), index.spill_fraction,
                       arr(index.packed_img_scale), arr(index.packed_txt_scale), arr(index.cb_img), arr(index.cb_txt))


@pytest.mark.parametrize("quantize", [None, "int8", "int4", "pq"])
@pytest.mark.parametrize("n", SHARDS)
def test_sharded_ivf_matches_jax(devices8, data, n, quantize):
    nlist = 16
    index = TA.build_ivf_index(data["img"], data["txt"], nlist, quantize=quantize, pq_m=4 if quantize == "pq" else None)
    jindex = _jax_index(index)
    jm, tm = _meshes(devices8, n)
    q = data["q"]
    for nprobe in (3, nlist):  # 3: the best ceil(3 / n) clusters a shard; nlist: every cluster
        for k in (10, 40):
            j = JA.sharded_ivf_search(jnp.asarray(q), jindex, k=k, nprobe=nprobe, mesh=jm,
                                      alpha=jnp.asarray(data["alpha"]))
            t = TA.sharded_ivf_search(torch.tensor(q), index, k=k, nprobe=nprobe, mesh=tm,
                                      alpha=torch.tensor(data["alpha"]))
            jv, tv = np.asarray(j[0]), t[0].numpy()
            np.testing.assert_array_equal(np.isfinite(tv), np.isfinite(jv))
            fin = np.isfinite(jv)
            np.testing.assert_allclose(tv[fin], jv[fin], rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))
    if quantize is None:
        # every cluster probed: brute force over the exact rows
        a = data["alpha"][:, None]
        s = a * (q @ data["img"].T) + (1 - a) * (q @ data["txt"].T)
        want = np.argsort(-s, axis=1, kind="stable")[:, :10]
        t = TA.sharded_ivf_search(torch.tensor(q), TA.shard_ivf_index(index, tm), k=10, nprobe=nlist, mesh=tm,
                                  alpha=torch.tensor(data["alpha"]))
        np.testing.assert_array_equal(t[1].numpy(), want)
        np.testing.assert_allclose(t[0].numpy(), np.take_along_axis(s, want, 1), rtol=TOL, atol=TOL)


def test_ivf_nlist_must_tile_the_axis(data):
    index = TA.build_ivf_index(data["img"], data["txt"], 6)
    with pytest.raises(ValueError, match="does not shard 4 ways"):
        TA.shard_ivf_index(index, make_mesh(MeshConfig(data_parallel=4), [torch.device("cpu")] * 4))


def test_merge_keeps_the_lowest_row_on_ties():
    """Equal scores across shards: the merge keeps the lowest global row,
    as ``lax.top_k`` over the gathered winners does."""
    tm = make_mesh(MeshConfig(data_parallel=4), [torch.device("cpu")] * 4)
    img = np.tile(_norm(np.ones((1, 8))), (16, 1))
    q = _norm(np.ones((2, 8)))
    v, i = TS.sharded_similarity_topk(torch.tensor(q), torch.tensor(img), torch.tensor(img), 6, 0.5, tm)
    np.testing.assert_array_equal(i.numpy(), np.tile(np.arange(6), (2, 1)))
