"""Pipeline, sequence and expert parallelism: the port against the JAX package.

The cases of ``tests/test_{pp,sp,ep}.py``: the JAX functions run over the
conftest's virtual devices, the port's over ``cpu`` repeated, on the same
seeded inputs and weights (flax blocks carried over with
``flax_to_openai``), at the JAX tests' tolerances, and ``axis_row``: the row
of a mesh across processes that each process computes (the two-process runs
are ``tests/test_torch_pp_sp_ep_multiprocess.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMeshArr

from knowledge_enhanced_multimodal_retrieval_tpu.models import clip as JM
from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import flax_to_openai
from knowledge_enhanced_multimodal_retrieval_tpu.ops.attention import mha_xla
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import ep as JE
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import pp as JP
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import sp as JS
from knowledge_enhanced_multimodal_retrieval_tpu_torch.models import clip as TM
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import ep as TE
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import pp as TP
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import sp as TS
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import Mesh, axis_row

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jmesh(n, axis):
    return JMeshArr(np.array(jax.devices()[:n]), (axis,))


def tmesh(n, axis):
    arr = np.empty(n, dtype=object)
    arr[:] = [CPU] * n
    return Mesh(arr, (axis,))


def t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- pipeline


def toy_layers(n, d, seed):
    rng = np.random.default_rng(seed)
    return [{"w": (rng.standard_normal((d, d)) * 0.2).astype(np.float32),
             "b": (rng.standard_normal(d) * 0.1).astype(np.float32)} for _ in range(n)]


def j_toy(p, x):
    return x + jnp.tanh(x @ p["w"] + p["b"])


def t_toy(p, x):
    return x + torch.tanh(x @ p["w"] + p["b"])


@pytest.mark.parametrize("stages, n_layers, shape", [(4, 8, (6, 4, 16)), (1, 3, (2, 2, 8))])
def test_pipeline_matches_jax_and_the_sequential_stack(stages, n_layers, shape):
    layers = toy_layers(n_layers, shape[-1], stages)
    xs = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = JP.pipeline_apply(j_toy, JP.stack_stages([jax.tree_util.tree_map(jnp.asarray, p) for p in layers], stages),
                             jnp.asarray(xs), jmesh(stages, "pipe"))
    got = TP.pipeline_apply(t_toy, TP.stack_stages([{k: t(v) for k, v in p.items()} for p in layers], stages),
                            t(xs), tmesh(stages, "pipe"))
    seq = t(xs)
    for p in layers:
        seq = t_toy({k: t(v) for k, v in p.items()}, seq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=2e-5, atol=2e-5)


def test_pipeline_grads_match_the_sequential_stack():
    """Autograd through the schedule is the reverse pipeline: the stacked
    parameters' gradients equal the sequential stack's (and JAX's)."""
    layers = toy_layers(4, 8, 4)
    xs = np.random.default_rng(5).standard_normal((5, 2, 8)).astype(np.float32)
    sp = {k: v.requires_grad_() for k, v in TP.stack_stages([{k: t(v) for k, v in p.items()} for p in layers], 4).items()}
    (TP.pipeline_apply(t_toy, sp, t(xs), tmesh(4, "pipe")) ** 2).sum().backward()
    jsp = JP.stack_stages([jax.tree_util.tree_map(jnp.asarray, p) for p in layers], 4)
    g = jax.grad(lambda s: jnp.sum(JP.pipeline_apply(j_toy, s, jnp.asarray(xs), jmesh(4, "pipe")) ** 2))(jsp)
    for k in sp:
        np.testing.assert_allclose(sp[k].grad.numpy(), np.asarray(g[k]), rtol=1e-4, atol=1e-4)


def test_pipeline_real_clip_blocks():
    """A tiny text tower's 8 blocks staged 4 ways: the JAX pipeline and the
    port's over its ``ResidualBlock`` (``torch.func.functional_call``)."""
    arch = JM.CLIPArch(16, 32, 1, 32, 16, 16, 64, 32, 2, 8, vision_heads=2)
    params = JM.init_params(JM.CLIP(arch, dtype=jnp.float32), jax.random.PRNGKey(0))
    layer_list = [params["text"]["transformer"][f"resblocks_{i}"] for i in range(8)]
    block = JM.ResidualBlock(arch.text_width, arch.text_heads, jnp.float32)
    xs = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 2, 16, 32), jnp.float32))
    want = JP.pipeline_apply(lambda p, x: block.apply({"params": p}, x, True), JP.stack_stages(layer_list, 4),
                             jnp.asarray(xs), jmesh(4, "pipe"))
    sd = flax_to_openai(jax.tree_util.tree_map(np.asarray, params))
    per = [{k[len(f"transformer.resblocks.{i}."):]: t(v) for k, v in sd.items()
            if k.startswith(f"transformer.resblocks.{i}.")} for i in range(8)]
    tblock = TM.ResidualBlock(32, 2)
    got = TP.pipeline_apply(lambda p, x: torch.func.functional_call(tblock, p, (x, True)), TP.stack_stages(per, 4),
                            t(xs), tmesh(4, "pipe"))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_stack_stages_validates():
    layers = [{k: t(v) for k, v in p.items()} for p in toy_layers(6, 4, 6)]
    with pytest.raises(ValueError, match="equal stages"):
        TP.stack_stages(layers, 4)
    assert TP.stack_stages(layers, 3)["w"].shape[:2] == (3, 2)


# ---------------------------------------------------------------- sequence


def qkv(seed, b=2, h=2, s=32, d=8):
    return [np.asarray(x) for x in jax.random.normal(jax.random.PRNGKey(seed), (3, b, h, s, d), jnp.float32)]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax_and_dense(causal):
    q, k, v = qkv(0)
    want = JS.ring_attention(*map(jnp.asarray, (q, k, v)), jmesh(8, "seq"), causal=causal)
    got = TS.ring_attention(t(q), t(k), t(v), tmesh(8, "seq"), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(mha_xla(*map(jnp.asarray, (q, k, v)), causal=causal)),
                               rtol=2e-5, atol=2e-5)


def test_ring_attention_grads_and_bf16():
    q, k, v = qkv(3, s=16)
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(4), q.shape, jnp.float32))
    jg = jax.grad(lambda a, b_, c: jnp.sum(JS.ring_attention(a, b_, c, jmesh(4, "seq"), causal=True) * w),
                  argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [t(x).requires_grad_() for x in (q, k, v)]
    (TS.ring_attention(*ts, tmesh(4, "seq"), causal=True) * t(w)).sum().backward()
    for a, b in zip(ts, jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=3e-5, atol=3e-5)
    bf = [t(x).bfloat16() for x in qkv(5)]
    got = TS.ring_attention(*bf, tmesh(8, "seq"))
    assert got.dtype == torch.bfloat16
    want = mha_xla(*(jnp.asarray(x.float().numpy()) for x in bf))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("causal", [False, True])
def test_sp_block_matches_jax_and_the_residual_block(causal):
    width, heads, s = 32, 2, 16
    block = JM.ResidualBlock(width, heads, jnp.float32)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(6), (2, s, width), jnp.float32))
    fp = block.init(jax.random.PRNGKey(7), jnp.asarray(x))["params"]
    want = JS.sp_block_apply(fp, jnp.asarray(x), jmesh(8, "seq"), heads=heads, causal=causal)
    wrapped = {"visual": {"transformer": {"resblocks_0": fp}}}
    sd = {k[len("visual.transformer.resblocks.0."):]: t(v) for k, v in _block_openai(wrapped).items()}
    got = TS.sp_block_apply(sd, t(x), tmesh(8, "seq"), heads=heads, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5, atol=3e-5)
    tblock = TM.ResidualBlock(width, heads)
    tblock.load_state_dict(sd)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), tblock(t(x), causal).numpy(), rtol=3e-5, atol=3e-5)


def _block_openai(tree):
    from knowledge_enhanced_multimodal_retrieval_tpu.models.convert import _block_to_openai

    out = {}
    _block_to_openai(jax.tree_util.tree_map(np.asarray, tree["visual"]["transformer"]["resblocks_0"]),
                     "visual.transformer.resblocks.0", out)
    return out


def test_sp_validation_errors():
    q, k, v = (t(x) for x in qkv(10))
    with pytest.raises(ValueError, match="no axis"):
        TS.ring_attention(q, k, v, tmesh(8, "seq"), axis="nope")
    with pytest.raises(ValueError, match="not divisible"):
        TS.ring_attention(q[:, :, :30], k[:, :, :30], v[:, :, :30], tmesh(8, "seq"))
    with pytest.raises(ValueError, match="not divisible"):
        TS.sp_block_apply({}, torch.zeros(1, 30, 16), tmesh(8, "seq"), heads=2)


# ---------------------------------------------------------------- rows across processes


def grid(shape, names, **kw):
    """A mesh of distinct ``cpu:i`` devices (so each position is told apart)."""
    arr = np.empty(int(np.prod(shape)), dtype=object)
    arr[:] = [torch.device("cpu", i) for i in range(arr.size)]
    return Mesh(arr.reshape(shape), names, **kw)


GROUP = object()  # a stand-in process group: axis_row reads it only where torch.distributed runs


@pytest.mark.parametrize("per, index", [(2, 0), (2, 1), (1, 0), (1, 1)])
def test_axis_row_across_processes_gives_each_its_run_of_positions(per, index):
    """Case A: the leading axis spans the processes; each holds a
    contiguous run of the positions and the row's hops cross the group."""
    row = axis_row(grid((per,), ("pipe",), process_index=index, process_count=2, group=GROUP), "pipe")
    assert row.size == 2 * per and row.owners == tuple(i // per for i in range(2 * per))
    assert row.positions == [index * per + i for i in range(per)] and row.rank == index and row.group is GROUP
    assert [row.devices[p] for p in row.positions] == [torch.device("cpu", i) for i in range(per)]


@pytest.mark.parametrize("axis", ["pipe", "seq", "expert"])
def test_axis_row_inside_each_process_is_its_own_row(axis):
    """Case B: ``data`` spans the processes, the axis lies inside each:
    process 1 computes its own row in process (the row whose other
    coordinates were 0 globally held nothing of it)."""
    row = axis_row(grid((2, 2), ("data", axis), process_index=1, process_count=2, group=GROUP), axis)
    assert row.group is None and row.positions == [0, 1] and row.owners == (1, 1)
    assert row.devices == {0: torch.device("cpu", 0), 1: torch.device("cpu", 1)}


def test_axis_row_on_a_dcn_data_model_mesh():
    mesh = grid((1, 2, 2), ("dcn", "data", "model"), process_index=1, process_count=2, group=GROUP)
    assert axis_row(mesh, "model").devices == {0: torch.device("cpu", 0), 1: torch.device("cpu", 1)}
    assert axis_row(mesh, "data").devices == {0: torch.device("cpu", 0), 1: torch.device("cpu", 2)}
    dcn = axis_row(mesh, "dcn")
    assert dcn.owners == (0, 1) and dcn.devices == {1: torch.device("cpu", 0)} and dcn.group is GROUP


def _moe_call(mesh, axis):
    _, tp = moe_params(width=8, hidden=16, experts=4, key=5)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 6, 8)).astype(np.float32))
    return TE.moe_apply(tp, x, mesh=mesh, axis=axis)[0]


@pytest.mark.parametrize("axis", ["pipe", "seq", "expert"])
def test_process_one_of_a_data_mesh_computes_its_own_row(axis):
    """The reproduction: ``process_index=1`` of a ``("data", axis)`` mesh
    over two processes runs its own row and gives the one-process result
    (it raised ``TypeError`` / ``ZeroDivisionError``)."""
    layers = [{k: t(v) for k, v in p.items()} for p in toy_layers(4, 8, 9)]
    xs = t(np.random.default_rng(9).standard_normal((3, 2, 8)).astype(np.float32))
    q, k, v = (t(x) for x in qkv(12))
    call = {"pipe": lambda m: TP.pipeline_apply(t_toy, TP.stack_stages(layers, 2), xs, m, "pipe"),
            "seq": lambda m: TS.ring_attention(q, k, v, m, "seq", causal=True),
            "expert": lambda m: _moe_call(m, "expert")}[axis]
    got = call(grid((1, 2), ("data", axis), process_index=1, process_count=2, group=GROUP))
    np.testing.assert_array_equal(got.detach().numpy(), call(tmesh(2, axis)).detach().numpy())


def test_an_axis_across_processes_needs_its_group():
    """A mesh whose axis spans the processes carries its hops over the
    mesh's process group: without one the axis is refused by name."""
    mesh = grid((2,), ("seq",), process_index=0, process_count=2)
    q, k, v = (t(x) for x in qkv(12))
    for call in (lambda: TS.ring_attention(q, k, v, mesh),
                 lambda: TP.pipeline_apply(t_toy, {"w": torch.zeros(4, 1, 8, 8), "b": torch.zeros(4, 1, 8)},
                                           torch.zeros(2, 1, 8), dataclasses.replace(mesh, axis_names=("pipe",)),
                                           axis="pipe")):
        with pytest.raises(ValueError, match="axis spans 2 processes but the mesh has no process group"):
            call()


def test_positions_that_do_not_tile_the_ranks_are_refused():
    """A mesh that lays its axis over two processes while its group has one
    rank: the positions do not tile the ranks."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        mesh = grid((2,), ("expert",), process_index=0, process_count=2, group=dist.group.WORLD)
        with pytest.raises(ValueError, match="'expert' axis: its 4 positions lie on 2 processes, but its group has 1"):
            _moe_call(mesh, "expert")
    finally:
        dist.destroy_process_group()


def test_stages_or_experts_that_do_not_split_evenly_are_refused():
    layers = [{k: t(v) for k, v in p.items()} for p in toy_layers(6, 8, 6)]
    with pytest.raises(ValueError, match="3 stages do not split evenly over pipe=2"):
        TP.pipeline_apply(t_toy, TP.stack_stages(layers, 3), torch.zeros(2, 1, 8), tmesh(2, "pipe"))
    with pytest.raises(ValueError, match="4 experts do not split over expert=8"):
        _moe_call(tmesh(8, "expert"), "expert")


# ---------------------------------------------------------------- experts


def moe_params(width=8, hidden=16, experts=4, key=0):
    jp = JE.init_moe_params(jax.random.PRNGKey(key), width, hidden, experts)
    tp = jax.tree_util.tree_map(lambda a: t(a), jp)
    return jp, tp


@pytest.mark.parametrize("k, capacity", [(1, 18), (2, 18), (2, None)])
def test_moe_matches_jax(k, capacity):
    jp, tp = moe_params()
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (3, 6, 8), jnp.float32))
    jy, jaux = JE.moe_apply(jp, jnp.asarray(x), k=k, capacity=capacity)
    ty, taux = TE.moe_apply(tp, t(x), k=k, capacity=capacity)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)


def test_overflow_tokens_drop_to_zero_and_slots():
    jp, tp = moe_params(width=4, hidden=8, experts=2)
    tp["router"]["kernel"] = torch.tensor([[5.0, -5.0]] * 4)  # everything to expert 0
    x = torch.ones(4, 4)
    y, _ = TE.moe_apply(tp, x, k=1, capacity=2)
    assert torch.all(y[2:] == 0) and torch.any(y[:2] != 0)
    dispatch, combine, _ = TE.router_dispatch(torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]]), 1, 2)
    jd, jc, _ = JE.router_dispatch(jnp.asarray([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]]), 1, 2)
    assert dispatch.shape == (3, 2, 2)
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(jd))
    np.testing.assert_allclose(combine.numpy(), np.asarray(jc), rtol=1e-6)


def test_expert_sharded_matches_unsharded_and_jax():
    jp, tp = moe_params(width=16, hidden=32, experts=8, key=3)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(4), (2, 12, 16), jnp.float32))
    jmesh8 = jmesh(8, "expert")
    want, jaux = jax.jit(lambda p, x_: JE.moe_apply(p, x_))(jax.device_put(jp, JE.ep_shardings(jmesh8, jp)),
                                                             jnp.asarray(x))
    got, aux = TE.moe_apply(tp, t(x), mesh=tmesh(8, "expert"))
    plain, _ = TE.moe_apply(tp, t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5, atol=2e-5)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    placed = TE.ep_shardings(tmesh(8, "expert"), tp)
    assert placed["w_in"].spec == ("expert", None, None) and placed["router.kernel"].is_fully_replicated
    with pytest.raises(ValueError, match="no axis"):
        TE.ep_shardings(tmesh(8, "data"), tp)
    g = TE.init_moe_params(torch.Generator().manual_seed(0), 8, 16, 4)
    assert g["w_in"].shape == (4, 8, 16) and g["router"]["kernel"].shape == (8, 4)
