"""Pipeline, sequence and expert parallelism across two processes: the port against the JAX package.

Two workers (``tests/mp_torch_pp_sp_ep_worker.py``) join ``torch.distributed``
over gloo and run ``pipeline_apply``, ``ring_attention``, ``sp_block_apply``
and the expert-sharded ``moe_apply`` forward and backward on every layout
of the worker's ``CASES``: the axis across the processes with two positions
a process and with one (case A; each rank's rows of the other ranks'
stages, sequence shards or experts are NaN), and ``data`` across the
processes with the axis inside each (case B). The workers start once for
all layouts. Every rank's output, and the gradients in the rows it owns,
are held to the JAX functions over the conftest's virtual devices and to
the port's one-process call, at the tolerances of
``tests/test_torch_pp_sp_ep.py``; the rows a rank does not own hold zeros.
Worker output goes to files, never pipes (the two are coupled by hops).
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMeshArr

from knowledge_enhanced_multimodal_retrieval_tpu.parallel import ep as JE
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import pp as JP
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import sp as JS
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import Mesh
from tests import mp_torch_pp_sp_ep_worker as W

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_ROOT, "tests", "mp_torch_pp_sp_ep_worker.py")
# forward, gradients (tests/test_torch_pp_sp_ep.py)
TOL = {"pp": (2e-5, 1e-4), "ring": (2e-5, 3e-5), "block": (3e-5, 2e-4), "moe": (1e-5, 2e-5)}
CASE_NAMES = [c[0] for c in W.CASES]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# the worker's [out, in] block names -> (the JAX block's flax path, transposed)
_FLAX = {f"{ln}.{n}": ((ln, "ln", leaf), False) for ln in ("ln_1", "ln_2") for n, leaf in (("weight", "scale"),
                                                                                          ("bias", "bias"))}
_FLAX.update({"attn.in_proj_weight": (("attn", "in_proj", "kernel"), True),
              "attn.in_proj_bias": (("attn", "in_proj", "bias"), False)})
_FLAX.update({f"{m}.{n}": ((*m.split("."), "kernel" if n == "weight" else "bias"), n == "weight")
              for m in ("attn.out_proj", "mlp.c_fc", "mlp.c_proj") for n in ("weight", "bias")})


def _flax_block(p):
    """The worker's ``[out, in]`` block dict in the JAX block's flax layout."""
    tree = {}
    for name, (path, transposed) in _FLAX.items():
        sub = tree
        for part in path[:-1]:
            sub = sub.setdefault(part, {})
        sub[path[-1]] = p[name].T if transposed else p[name]
    return tree


def _vjp(fn, args, w):
    """``fn(*args)`` and its vjp at ``w``, in one compiled program."""
    def run(args, w):
        out, vjp = jax.vjp(fn, *args)
        return out, vjp(w)

    return jax.jit(run)(args, w)


def _jax_reference(kind, axes, size, data):
    """The JAX function's output and gradients over the conftest's devices,
    keyed as the worker keys them."""
    n_dev = 2 * size if len(axes) == 2 else size
    mesh = JMeshArr(np.array(jax.devices()[:n_dev]).reshape((2, size) if len(axes) == 2 else (size,)), axes)
    axis = axes[-1]
    w = jnp.asarray(data["w"])
    if kind == "pp":
        stacked = JP.stack_stages([jax.tree_util.tree_map(jnp.asarray, p) for p in data["layers"]], size)
        out, (gs, gx) = _vjp(lambda s, x: JP.pipeline_apply(lambda p, h: h + jnp.tanh(h @ p["w"] + p["b"]), s, x,
                                                            mesh, axis), (stacked, jnp.asarray(data["xs"])), w)
        return out, dict({f"stage.{k}": v for k, v in gs.items()}, xs=gx)
    if kind == "ring":
        out, grads = _vjp(lambda q, k, v: JS.ring_attention(q, k, v, mesh, axis, causal=True),
                          tuple(jnp.asarray(data[n]) for n in "qkv"), w)
        return out, dict(zip("qkv", grads))
    if kind == "block":
        flax = jax.tree_util.tree_map(jnp.asarray, _flax_block(data["params"]))
        out, (gp, gx) = _vjp(lambda p, x: JS.sp_block_apply(p, x, mesh, heads=W.BLOCK_HEADS, axis=axis, causal=True),
                             (flax, jnp.asarray(data["x"])), w)
        grads = {"x": gx}
        for name, (path, transposed) in _FLAX.items():
            g = gp
            for part in path:
                g = g[part]
            grads[f"param.{name}"] = g.T if transposed else g
        return out, grads
    params = jax.tree_util.tree_map(jnp.asarray, data["params"])

    def loss(p, x):
        y, aux = JE.moe_apply(p, x, k=2)
        return jnp.sum(y * w) + aux, (y, aux)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(data["x"]))
    grads = dict({f"param.{n}": gp[n] for n in ("w_in", "b_in", "w_out", "b_out")}, router=gp["router"]["kernel"],
                 x=gx, aux=aux)
    return out, grads


def _one_process(kind, axes, size, data):
    arr = np.empty(2 * size if len(axes) == 2 else size, dtype=object)
    arr[:] = [torch.device("cpu")] * arr.size
    return W.compute(kind, data, Mesh(arr.reshape((2, size) if len(axes) == 2 else (size,)), axes))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' reports, and per case the JAX and one-process references."""
    out = tmp_path_factory.mktemp("pp_sp_ep_mp")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = _ROOT + os.pathsep + env.get("PYTHONPATH", "")
    port = str(_free_port())
    logs = [open(out / f"w{r}.log", "w+") for r in range(2)]
    procs = []
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        procs = [subprocess.Popen([sys.executable, _WORKER, str(r), "2", port, str(out)], env=env, stdout=log,
                                  stderr=subprocess.STDOUT, text=True) for r, log in enumerate(logs)]
        refs = {}
        for name, kind, axes, local in W.CASES:  # while the workers run
            size = W.size_of(axes, local, 2)
            data = W.inputs(kind, size)
            jo, jg = _jax_reference(kind, axes, size, data)
            refs[name] = dict(jax=(np.asarray(jo), {k: np.asarray(v) for k, v in jg.items()}),
                              one=_one_process(kind, axes, size, data), size=size)
        for p in procs:
            p.wait(timeout=120)
    finally:
        torch.set_num_threads(n)
        for p in procs:  # never leave a hop-blocked worker behind
            if p.poll() is None:
                p.kill()
                p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
    for p, text in zip(procs, texts):
        assert p.returncode == 0, f"worker failed:\n{text[-4000:]}"
    ranks = [torch.load(out / f"r{r}.pt", weights_only=False) for r in range(2)]
    return ranks, refs


def _kind(name):
    return name.split()[0]


@pytest.mark.parametrize("name", CASE_NAMES)
def test_every_rank_holds_the_whole_output(runs, name):
    """Each rank's output (replicated) against JAX and the one-process call."""
    ranks, refs = runs
    tol = TOL[_kind(name)][0]
    jax_out, one = refs[name]["jax"][0], refs[name]["one"]["out"].numpy()
    for rank in ranks:
        got = rank[name]["out"].numpy()
        assert np.isfinite(got).all(), f"{name} rank {ranks.index(rank)}: a non-finite output (a NaN row was read)"
        np.testing.assert_allclose(got, jax_out, rtol=tol, atol=tol)
        np.testing.assert_allclose(got, one, rtol=tol, atol=tol)


def _owned(kind, key, size, positions):
    """The rows of gradient ``key`` that a rank owns (dim, slices), or None
    for a gradient every rank holds whole."""
    cut = {"pp": {"stage.w": 0, "stage.b": 0},
           "ring": {"q": 2, "k": 2, "v": 2},
           "block": {"x": 1},
           "moe": {"param.w_in": 0, "param.b_in": 0, "param.w_out": 0, "param.b_out": 0}}[kind]
    if key not in cut:
        return None
    total = {"pp": size, "ring": W.QKV_SHAPE[2], "block": W.BLOCK_X[1], "moe": W.MOE_EXPERTS}[kind]
    return cut[key], W.own_rows(kind, size, positions, total)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_each_rank_holds_the_one_process_gradient_in_its_rows(runs, name):
    """Gradients in the rows a rank owns (or whole, where every rank holds
    them) against JAX and the one-process call; zeros in the others."""
    ranks, refs = runs
    kind, tol = _kind(name), TOL[_kind(name)][1]
    jax_grads, one = refs[name]["jax"][1], refs[name]["one"]["grads"]
    for r, rank in enumerate(ranks):
        rep = rank[name]
        assert set(rep["grads"]) == set(jax_grads) == set(one)
        for key, g in rep["grads"].items():
            g = g.numpy()
            assert np.isfinite(g).all(), f"{name} rank {r} {key}: a non-finite gradient"
            want_j, want_o = jax_grads[key], one[key].numpy()
            if key == "aux":
                assert float(g) == pytest.approx(float(want_j), rel=1e-5)
                continue
            owned = _owned(kind, key, refs[name]["size"], rep["positions"])
            if owned is None:
                np.testing.assert_allclose(g, want_j, rtol=tol, atol=tol, err_msg=f"{name} rank {r} {key}")
                np.testing.assert_allclose(g, want_o, rtol=tol, atol=tol, err_msg=f"{name} rank {r} {key}")
                continue
            dim, slices = owned
            mask = np.zeros(g.shape[dim], dtype=bool)
            for sl in slices:
                mask[sl] = True
            take = lambda a, m: np.compress(m, a, axis=dim)  # noqa: E731
            np.testing.assert_allclose(take(g, mask), take(want_j, mask), rtol=tol, atol=tol,
                                       err_msg=f"{name} rank {r} {key}")
            np.testing.assert_allclose(take(g, mask), take(want_o, mask), rtol=tol, atol=tol,
                                       err_msg=f"{name} rank {r} {key}")
            assert not take(g, ~mask).any(), f"{name} rank {r} {key}: rows it does not own hold a gradient"


@pytest.mark.parametrize("name", CASE_NAMES)
def test_hops_cross_only_where_the_axis_spans_the_processes(runs, name):
    """Case A: each rank owns its share of the positions, and its hops and
    reductions crossed (gloo: as CPU tensors); case B: each rank owns its
    whole row (the reproduction's ``process_index=1`` included) and nothing
    crossed."""
    ranks, refs = runs
    size = refs[name]["size"]
    spans = name.split()[1] != "B"
    owned = []
    for rank in ranks:
        rep = rank[name]
        assert rep["spans"] is spans
        owned.append(rep["positions"])
        hops = rep["hops"]
        if not spans:
            assert rep["positions"] == list(range(size)) and hops == {}
            continue
        assert hops["reduce"]["messages"] > 0 and hops["reduce"]["host_bytes"] == hops["reduce"]["bytes"] > 0
        if _kind(name) in ("pp", "ring", "block"):
            assert hops["p2p"]["host_bytes"] == hops["p2p"]["bytes"] > 0
        else:
            assert "p2p" not in hops  # the experts' shares need no hop, only the two reductions
    if spans:
        assert sorted(owned[0] + owned[1]) == list(range(size)) and not set(owned[0]) & set(owned[1])
