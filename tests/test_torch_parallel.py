"""The port's device mesh and placements, held to the JAX package's.

``parallel.make_mesh`` / ``MeshRuntime`` over ``[cpu] * 8`` against the JAX
ones over the conftest's 8 virtual CPU devices: shapes, ``num_data``, the
data axes, the placements' specs and the tiling errors (same messages);
``pad_to_multiple`` against JAX's; row shards (views on the device that
holds the rows, copies elsewhere, the process-major gather) and
``runtime_init``'s single-process no-op.
"""

import numpy as np
import pytest
import torch

from knowledge_enhanced_multimodal_retrieval_tpu.parallel import MeshRuntime as JMeshRuntime
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import make_mesh as jmake_mesh
from knowledge_enhanced_multimodal_retrieval_tpu.parallel import pad_to_multiple as jpad
from knowledge_enhanced_multimodal_retrieval_tpu.utils.config import MeshConfig as JMeshConfig
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import (
    MeshRuntime,
    RowShards,
    make_mesh,
    pad_to_multiple,
    runtime_init,
    shard_rows,
    unreplicate,
)
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.mesh import default_devices
from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel.sharding import all_gather_processes, replicate
from knowledge_enhanced_multimodal_retrieval_tpu_torch.utils.config import MeshConfig

CPU8 = [torch.device("cpu")] * 8
LAYOUTS = [dict(), dict(data_parallel=2, model_parallel=4), dict(data_parallel=4, model_parallel=2),
           dict(dcn_parallel=2), dict(dcn_parallel=2, model_parallel=2), dict(data_parallel=8)]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_shape_matches_jax(devices8, layout):
    jm = jmake_mesh(JMeshConfig(**layout))
    tm = make_mesh(MeshConfig(**layout), CPU8)
    assert tm.shape == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.size == jm.size == 8


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mesh_runtime_matches_jax(devices8, layout):
    jrt = JMeshRuntime.create(JMeshConfig(**layout))
    trt = MeshRuntime.create(MeshConfig(**layout), CPU8)
    assert trt.num_data == jrt.num_data
    assert trt.data_axes == jrt.data_axes
    assert trt.dcn_axis == jrt.dcn_axis
    for ndim in (1, 2, 3):
        assert trt.data_sharding(ndim).spec == tuple(jrt.data_sharding(ndim).spec)
    assert trt.replicated_sharding().spec == tuple(jrt.replicated_sharding().spec)
    assert trt.replicated_sharding().is_fully_replicated


@pytest.mark.parametrize("layout", [dict(data_parallel=3), dict(data_parallel=2, model_parallel=2),
                                    dict(dcn_parallel=3), dict(data_parallel=16)])
def test_tiling_errors_match_jax(devices8, layout):
    with pytest.raises(ValueError) as jerr:
        jmake_mesh(JMeshConfig(**layout))
    with pytest.raises(ValueError) as terr:
        make_mesh(MeshConfig(**layout), CPU8)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("n, multiple, axis", [(13, 8, 0), (16, 8, 0), (5, 3, 1), (1, 4, 0), (7, 1, 0)])
def test_pad_to_multiple_matches_jax(n, multiple, axis):
    x = np.arange(n * 3, dtype=np.float32).reshape((n, 3) if axis == 0 else (3, n))
    jp, jn = jpad(x, multiple, axis=axis, pad_value=-1)
    tp, tn = pad_to_multiple(x, multiple, axis=axis, pad_value=-1)
    assert tn == jn
    np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("layout, shards", [(dict(), 8), (dict(data_parallel=2, model_parallel=4), 2),
                                            (dict(dcn_parallel=2), 4)])
def test_axis_shards_one_per_index(layout, shards):
    """A data-sharded array is replicated over the other axes: one grid
    position per data index computes (the one whose other coordinates are 0)."""
    m = make_mesh(MeshConfig(**layout), CPU8)
    got = m.axis_shards("data")
    assert [g for g, _ in got] == list(range(shards))


def test_shard_rows_views_on_the_holding_device():
    m = make_mesh(MeshConfig(data_parallel=4), [torch.device("cpu")] * 4)
    x = torch.arange(24 * 3, dtype=torch.float32).reshape(24, 3)
    rs = shard_rows(x, m)
    assert isinstance(rs, RowShards) and rs.shard_n == 6 and rs.n_shards == 4 and rs.shape == (24, 3)
    for g, part in rs.shards:
        assert part.data_ptr() == x[g * 6].data_ptr()  # a view, not a copy
    torch.testing.assert_close(rs.gather(), x)
    assert shard_rows(rs, m) is rs
    np.testing.assert_array_equal(unreplicate(rs), x.numpy())
    with pytest.raises(ValueError, match="do not shard 4 ways"):
        shard_rows(torch.zeros(10, 3), m)
    # host arrays shard too
    torch.testing.assert_close(shard_rows(x.numpy(), m).gather(), x)


def test_placements():
    rt = MeshRuntime.create(MeshConfig(data_parallel=2), [torch.device("cpu")] * 2)
    x = torch.ones(4, 2)
    placed = rt.data_sharding(2).place(x)
    assert isinstance(placed, RowShards) and placed.shard_n == 2
    rep = rt.replicated_sharding().place(x)
    assert list(rep) == [torch.device("cpu")] and rep[torch.device("cpu")] is x
    assert replicate(x, rt.mesh)[torch.device("cpu")] is x
    # rows over ('dcn', 'data') jointly, outer axis major (JAX's tuple all_gather order)
    dcn = MeshRuntime.create(MeshConfig(dcn_parallel=2, data_parallel=2), [torch.device("cpu")] * 4)
    rows = torch.arange(8.0).reshape(8, 1)
    joint = dcn.data_sharding(2).place(rows)
    assert joint.n_shards == 4 and [g for g, _ in joint.shards] == [0, 1, 2, 3]
    torch.testing.assert_close(joint.gather(), rows)
    assert [t[0, 0].item() for _, t in joint.shards] == [0.0, 2.0, 4.0, 6.0]


def test_default_devices_on_the_cpu():
    assert default_devices(MeshConfig(data_parallel=4), "cpu") == [torch.device("cpu")] * 4
    assert default_devices(MeshConfig(data_parallel=2, model_parallel=2), "cpu") == [torch.device("cpu")] * 4
    assert default_devices(MeshConfig(), "cpu") == [torch.device("cpu")]


def test_operands_device_of_cpu_operands_is_none():
    from knowledge_enhanced_multimodal_retrieval_tpu_torch.ops import dispatch

    assert dispatch.operands_device((torch.ones(2), 3), {"alpha": torch.ones(1)}) is None


def test_default_devices_never_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        default_devices(MeshConfig(data_parallel=4))


def test_default_devices_refuse_a_layout_larger_than_the_cards(monkeypatch):
    # one visible card: --mesh.data_parallel=4 is the tiling error, not four shards on the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cards = default_devices(MeshConfig(data_parallel=4))
    assert cards == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="does not tile 1 devices"):
        make_mesh(MeshConfig(data_parallel=4), cards)


def test_runtime_init_single_process_is_a_noop(monkeypatch):
    for var in ("WORLD_SIZE", "KEMR_NUM_PROCESSES", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert runtime_init() is None
    assert not torch.distributed.is_initialized()
    # without torch.distributed the process gather is the identity
    m = make_mesh(MeshConfig(), [torch.device("cpu")] * 2)
    x = torch.arange(6).reshape(2, 3)
    assert all_gather_processes(x, m) is x
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="no coordinator address"):
        runtime_init()
    assert not torch.distributed.is_initialized()


def test_all_reduce_crosses_in_bounded_buckets_of_the_tensors_dtype(monkeypatch):
    """``all_reduce_`` sends each dtype in flat buckets of at most
    ``REDUCE_BUCKET_BYTES`` (a larger tensor alone), in the tensors' own
    dtype unless ``dtype`` is given, and writes each tensor's sum back in
    place (a stand-in collective doubles each buffer: two equal processes)."""
    import torch.distributed as dist

    from knowledge_enhanced_multimodal_retrieval_tpu_torch.parallel import sharding

    sent = []

    def fake_all_reduce(flat, op=None, group=None):
        sent.append((flat.dtype, flat.numel() * flat.element_size()))
        flat.mul_(2)

    monkeypatch.setattr(dist, "get_backend", lambda group: "gloo")
    monkeypatch.setattr(dist, "all_reduce", fake_all_reduce)
    monkeypatch.setattr(sharding, "REDUCE_BUCKET_BYTES", 64)
    ts = [torch.arange(6, dtype=torch.float32).reshape(2, 3), torch.ones(10), torch.full((3,), 0.5, dtype=torch.bfloat16),
          torch.arange(40, dtype=torch.float32), torch.ones(2)]
    want = [t * 2 for t in ts]
    sharding.all_reduce_(ts, group=object())
    for t, w in zip(ts, want):
        assert t.dtype == w.dtype and torch.equal(t, w)
    assert sent == [(torch.float32, 64), (torch.float32, 160), (torch.float32, 8), (torch.bfloat16, 6)]
    sent.clear()
    scalars = [torch.tensor(1.5), torch.tensor(2.5)]
    sharding.all_reduce_(scalars, group=object(), dtype=torch.float64)
    assert sent == [(torch.float64, 16)] and [float(s) for s in scalars] == [3.0, 5.0]
    assert scalars[0].dtype == torch.float32
