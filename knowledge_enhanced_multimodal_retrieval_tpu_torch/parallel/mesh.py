"""Device mesh + distributed runtime bootstrap.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/parallel/mesh.py``.
JAX runs one controller per process over a ``jax.sharding.Mesh`` of the
devices that process addresses, and ``jax.distributed`` across processes.
The port keeps that layering:

- inside a process, a :class:`Mesh` is a grid of ``torch.device``s with
  named axes (``data``, ``model`` and, for multi-slice layouts, a leading
  ``dcn``). A sharded op places shard *i* of an array on the device at
  position *i* of an axis and runs there; a device may repeat in the grid
  (``[cuda:0] * 4`` is four shards on one card, the counterpart of JAX's
  virtual CPU devices);
- across processes, ``torch.distributed`` joins them: every process holds
  the same number of grid positions, the global grid is the process-major
  concatenation, and the leading axis spans the processes. The ``[Q, k]``
  winners of a sharded scan and the serving work items cross
  (``parallel.sharding.all_gather_processes``, ``retrieval.multihost``), and
  pipeline, sequence and expert parallelism run over the row of an axis
  that :func:`axis_row` gives each process (hops between ranks where the
  axis spans the processes).

:func:`runtime_init` starts ``torch.distributed`` from torchrun's variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``), the JAX package's ``KEMR_NUM_PROCESSES`` standing for
``WORLD_SIZE`` and a coordinator address for ``MASTER_ADDR`` /
``MASTER_PORT``; it never runs at import and is a no-op for one process.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.config import MeshConfig


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def distributed_ready() -> bool:
    """True once ``torch.distributed`` has a default process group."""
    dist = _dist()
    return dist is not None and dist.is_initialized()


def canonical_device(d) -> torch.device:
    """``d`` as a tensor reports its device: ``cuda`` gains the current index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def pick_backend(world_size: int, local_world_size: Optional[int] = None) -> str:
    """NCCL where each rank of this host owns a card of its own, gloo
    otherwise (no card, or more ranks than cards: NCCL refuses two ranks on
    one device)."""
    local = local_world_size or world_size
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def runtime_init(coordinator_address: Optional[str] = None) -> Optional[str]:
    """Start ``torch.distributed`` when the process runs under a
    multi-process launcher; returns the backend that runs (None for one
    process). Safe to call unconditionally: an initialized group or a
    single-process run is a no-op.

    ``coordinator_address`` (``host:port``) takes the place of
    ``MASTER_ADDR`` / ``MASTER_PORT``, as in the JAX package."""
    dist = _dist()
    if dist is None:
        return None
    if dist.is_initialized():
        return dist.get_backend()
    env = os.environ
    world = int(env.get("WORLD_SIZE") or env.get("KEMR_NUM_PROCESSES") or 1)
    if world <= 1 and not coordinator_address:
        return None
    rank = int(env.get("RANK") or 0)
    address = coordinator_address
    if not address:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError(
                f"{world} processes but no coordinator address: set MASTER_ADDR / MASTER_PORT "
                "(torchrun does) or pass coordinator_address='host:port'"
            )
        address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    local_world = int(env.get("LOCAL_WORLD_SIZE") or world)
    backend = pick_backend(world, local_world)
    if backend == "nccl":
        local_rank = int(env.get("LOCAL_RANK") or rank % local_world)
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{address}", world_size=world, rank=rank)
    print(f"runtime_init: torch.distributed {backend}, rank {rank} of {world} via {address}", file=sys.stderr)
    return backend


def default_devices(cfg: MeshConfig = MeshConfig(), device_type: Optional[str] = None) -> List[torch.device]:
    """This process's devices when the caller names none: every visible card
    (under ``torch.distributed``, the rank's current card), or with
    ``device_type="cpu"`` ``cpu`` repeated ``data_parallel x model_parallel
    x dcn_parallel`` times over the processes (``data_parallel = -1`` counts
    as 1 there). A layout larger than the cards is :func:`make_mesh`'s
    tiling error; a mesh that repeats a card is built by naming it."""
    world = _dist().get_world_size() if distributed_ready() else 1
    if device_type == "cpu":
        asked = max(1, cfg.data_parallel) * max(1, cfg.model_parallel) * max(1, getattr(cfg, "dcn_parallel", 1))
        return [torch.device("cpu")] * max(1, asked // world)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible: name the CPU (device_type='cpu', --device=cpu) to run there")
    if world > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(eq=False)
class Mesh:
    """A named grid of devices spanning one or more processes.

    ``devices`` holds this process's positions (an object array of
    ``torch.device``s); ``shape`` is the global grid, the
    leading axis multiplied by ``process_count``. ``group`` is the
    ``torch.distributed`` group the processes share, or None for a mesh of
    one process without ``torch.distributed``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    process_index: int = 0
    process_count: int = 1
    group: object = None

    @property
    def shape(self) -> Dict[str, int]:
        dims = list(self.devices.shape)
        dims[0] *= self.process_count
        return dict(zip(self.axis_names, dims))

    @property
    def size(self) -> int:
        return int(self.devices.size) * self.process_count

    @property
    def local_devices(self) -> List[torch.device]:
        return list(self.devices.flat)

    @property
    def first_device(self) -> torch.device:
        """Where merged results land (the mesh's first local device)."""
        return self.devices.flat[0]

    def axis_size(self, axes) -> int:
        """The shard count of one axis or of a tuple of axes jointly."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([self.shape[a] for a in axes]))

    def axis_shards(self, axes) -> List[Tuple[int, torch.device]]:
        """``(index, device)`` of each shard of ``axes`` (one axis name, or a
        tuple of them sharded jointly, outer axis major) this process
        computes: the grid positions whose other coordinates are 0 (an array
        sharded on some axes is replicated over the others, and one replica
        computes)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [self.axis_names.index(a) for a in axes]
        dims = self.shape
        local = self.devices.shape
        out = []
        for pos in np.ndindex(*local):
            glob = list(pos)
            glob[0] += self.process_index * local[0]
            if all(c == 0 for i, c in enumerate(glob) if i not in idx):
                flat = 0
                for a, i in zip(axes, idx):
                    flat = flat * dims[a] + glob[i]
                out.append((flat, self.devices[pos]))
        return sorted(out, key=lambda t: t[0])

    def shard_rows_of_devices(self, axes, across: str) -> List[Tuple[int, Tuple[torch.device, ...]]]:
        """Like :meth:`axis_shards`, each shard with the devices along the
        axis ``across`` at its position (a data shard's tensor-parallel
        row of devices: ``across`` is the model axis)."""
        ax = self.axis_names.index(across)
        out = []
        for flat, _ in self.axis_shards(axes):
            pos = self._local_position(axes, flat)
            row = []
            for m in range(self.devices.shape[ax]):
                p = list(pos)
                p[ax] = m
                row.append(self.devices[tuple(p)])
            out.append((flat, tuple(row)))
        return out

    def _local_position(self, axes, flat: int) -> Tuple[int, ...]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        pos = [0] * self.devices.ndim
        for a in reversed(axes):
            i = self.axis_names.index(a)
            pos[i] = flat % self.shape[a]
            flat //= self.shape[a]
        if self.axis_names[0] in axes:
            pos[0] -= self.process_index * self.devices.shape[0]
        return tuple(pos)

    def local_coords(self, axis: str) -> List[int]:
        """The global indices along ``axis`` that this process's positions cover."""
        if self.axis_names.index(axis) != 0:
            return list(range(self.shape[axis]))
        n = self.devices.shape[0]
        return list(range(self.process_index * n, (self.process_index + 1) * n))


@dataclasses.dataclass(frozen=True)
class AxisRow:
    """One row of a mesh along one axis: what pipeline, sequence and expert
    parallelism run over. ``owners[i]`` is the rank (process index) that
    holds position ``i`` of the axis, ``devices`` maps this process's own
    positions to their devices, and ``group`` is the ``torch.distributed``
    group of the ranks that share the row, or None when the row lies inside
    this process."""

    axis: str
    owners: Tuple[int, ...]
    rank: int
    devices: Dict[int, torch.device]
    group: object = None

    @property
    def size(self) -> int:
        return len(self.owners)

    @property
    def positions(self) -> List[int]:
        """This process's positions along the axis, ascending."""
        return sorted(self.devices)


def axis_row(mesh: Mesh, axis: str) -> AxisRow:
    """The row of ``mesh`` along ``axis`` that this process computes.

    - The axis spans the processes (it is the leading axis and the mesh has
      several): every process holds a contiguous run of its positions, all
      processes share the one row, and its hops cross ``mesh.group``. The
      other axes lie inside each process and see replicated operands: the
      row at their coordinates 0 computes.
    - Otherwise the axis lies inside each process: the row at this process's
      first grid position (another axis may span the processes; every
      process computes its own row, in process).

    A row that spans processes needs the mesh's process group, one rank a
    process: anything else raises a ``ValueError`` that names the axis."""
    if axis not in mesh.shape:
        raise ValueError(f"mesh has no axis {axis!r}: {dict(mesh.shape)}")
    ax = mesh.axis_names.index(axis)
    local = mesh.devices.shape
    rest = (0,) * (len(local) - 1)
    if ax == 0 and mesh.process_count > 1:
        per = local[0]
        if mesh.group is None:
            raise ValueError(f"the {axis!r} axis spans {mesh.process_count} processes but the mesh has no process "
                             "group to carry its hops")
        if distributed_ready():
            ranks = _dist().get_world_size(mesh.group)
            if ranks != mesh.process_count:
                raise ValueError(f"the {axis!r} axis: its {mesh.shape[axis]} positions lie on {mesh.process_count} "
                                 f"processes, but its group has {ranks} ranks: the positions do not tile the ranks")
        owners = tuple(i // per for i in range(mesh.shape[axis]))
        first = mesh.process_index * per
        return AxisRow(axis, owners, mesh.process_index,
                       {first + i: mesh.devices[(i,) + rest] for i in range(per)}, mesh.group)
    pos = [0] * len(local)
    devices = {}
    for i in range(local[ax]):
        pos[ax] = i
        devices[i] = mesh.devices[tuple(pos)]
    return AxisRow(axis, (mesh.process_index,) * local[ax], mesh.process_index, devices)


def make_mesh(cfg: MeshConfig = MeshConfig(), devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Build a ``(data, model)`` or ``(dcn, data, model)`` mesh.

    ``devices`` are this process's devices (default :func:`default_devices`);
    under ``torch.distributed`` every process passes the same count and the
    global device list is their process-major concatenation.
    ``data_parallel == -1`` takes every device the other axes leave; the
    layout must tile the global device count (the JAX package's error)."""
    devs = [canonical_device(d) for d in (devices if devices is not None else default_devices(cfg))]
    dist = _dist()
    group = None
    rank, world = 0, 1
    if distributed_ready():
        group = dist.group.WORLD
        rank, world = dist.get_rank(), dist.get_world_size()
    n_global = len(devs) * world
    mp = max(1, cfg.model_parallel)
    dcn = max(1, getattr(cfg, "dcn_parallel", 1))
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n_global // (mp * dcn)
    if dcn * dp * mp != n_global:
        raise ValueError(f"mesh {dcn}x{dp}x{mp} (dcn x data x model) does not tile {n_global} devices")
    dims, names = ((dcn, dp, mp), (cfg.dcn_axis, cfg.data_axis, cfg.model_axis)) if dcn > 1 else (
        (dp, mp), (cfg.data_axis, cfg.model_axis))
    if dims[0] % world:
        raise ValueError(f"the leading mesh axis ({dims[0]}) does not split over {world} processes")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    local = (dims[0] // world,) + dims[1:]
    return Mesh(arr.reshape(local), names, process_index=rank, process_count=world, group=group)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where an array lives on a mesh: rows sharded over ``spec[0]``'s
    axes (a ``data_sharding``), or replicated on every device (``spec ==
    ()``): the port's ``NamedSharding``. ``place`` puts a tensor there."""

    mesh: Mesh
    spec: tuple

    @property
    def is_fully_replicated(self) -> bool:
        return not self.spec or all(s is None for s in self.spec)

    def place(self, x):
        from .sharding import replicate, shard_rows

        if self.is_fully_replicated:
            return replicate(x, self.mesh)
        return shard_rows(x, self.mesh, self.spec[0])


@dataclasses.dataclass
class MeshRuntime:
    """Bundle of mesh + canonical placements used throughout the framework."""

    mesh: Mesh
    data_axis: str = "data"
    model_axis: str = "model"
    fsdp: bool = False
    # the leading multi-slice axis name, or None for a (data, model) mesh
    dcn_axis: Optional[str] = None

    @staticmethod
    def create(cfg: MeshConfig = MeshConfig(), devices: Optional[Sequence[torch.device]] = None) -> "MeshRuntime":
        mesh = make_mesh(cfg, devices)
        dcn = cfg.dcn_axis if getattr(cfg, "dcn_parallel", 1) > 1 else None
        return MeshRuntime(mesh=mesh, data_axis=cfg.data_axis, model_axis=cfg.model_axis, fsdp=cfg.fsdp,
                           dcn_axis=dcn)

    @property
    def data_axes(self) -> tuple:
        """Every axis the batch shards over: ('dcn', 'data') or ('data',)."""
        return (self.dcn_axis, self.data_axis) if self.dcn_axis else (self.data_axis,)

    @property
    def num_data(self) -> int:
        """Total batch-sharding ways (across the dcn and data axes)."""
        n = self.mesh.shape[self.data_axis]
        if self.dcn_axis:
            n *= self.mesh.shape[self.dcn_axis]
        return n

    def data_sharding(self, ndim: int = 1) -> Placement:
        """Batch-sharded over the data axes; trailing dims replicated."""
        lead = self.data_axes if self.dcn_axis else self.data_axis
        return Placement(self.mesh, (lead,) + (None,) * (ndim - 1))

    def replicated_sharding(self) -> Placement:
        return Placement(self.mesh, ())
