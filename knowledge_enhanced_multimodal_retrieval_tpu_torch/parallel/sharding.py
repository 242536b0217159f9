"""Sharding helpers: row shards, replicas, padding, the cross-process gather.

The port's counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/parallel/sharding.py``
for serving. ``batch_sharding`` / ``replicated`` become placements that put
a tensor on a :class:`~.mesh.Mesh` as a :class:`RowShards` (rows cut into
equal contiguous shards, shard *i* on the device at position *i* of the
axis) or as one copy per distinct device. A shard on the device that
already holds the rows is a view, not a copy. For training,
``host_local_batch_to_global`` cuts each process's rows of a global batch
into its data shards, :class:`ShardedParams` holds a parameter dict cut into
blocks by a per-dimension spec (``parallel.fsdp``, ``parallel.tp``) and
builds parameters from them (its :class:`BuiltGauge` counts what is built
and alive), and :func:`all_gather_autograd` is the differentiable
cross-process gather. For pipeline, sequence and expert parallelism across
processes, :func:`exchange` carries the point-to-point hops (each send
posted beside its receives), and :func:`sum_partials` /
:func:`sum_gradients` are the two conjugate reductions; :data:`hop_log`
counts what they move.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import Mesh, Placement

_TMA_ALIGN = 16  # bytes: the kernels' tensor maps need 16-byte-aligned global addresses


def batch_sharding(mesh: Mesh, ndim: int, axis: str = "data") -> Placement:
    """Shard dim 0 over ``axis``, replicate the rest."""
    return Placement(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, pad_value=0) -> tuple:
    """Pad ``x`` along ``axis`` to a multiple of ``multiple``; returns
    ``(padded, original_len)`` (a sharded dim must divide the axis size)."""
    n = x.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return np.pad(x, widths, constant_values=pad_value), n


def unreplicate(x: Any) -> Any:
    """Fetch a tensor (or a dict / list / tuple of them) to host numpy."""
    if torch.is_tensor(x):
        t = x.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    if isinstance(x, RowShards):
        return unreplicate(x.gather())
    if isinstance(x, dict):
        return {k: unreplicate(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(unreplicate(v) for v in x)
    return np.asarray(x)


@dataclasses.dataclass(eq=False)
class RowShards:
    """An array row-sharded over one mesh axis: this process's shards as
    ``(global shard index, tensor on its device)`` pairs, each ``shard_n``
    rows of the ``n_shards * shard_n`` global ones."""

    shards: List[Tuple[int, torch.Tensor]]
    shard_n: int
    n_shards: int
    mesh: Mesh
    axis: str

    @property
    def shape(self) -> tuple:
        return (self.shard_n * self.n_shards,) + tuple(self.shards[0][1].shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0][1].dtype

    def gather(self) -> torch.Tensor:
        """This process's shards concatenated on the mesh's first device
        (every shard when one process holds the mesh)."""
        dev = self.mesh.first_device
        return torch.cat([t.to(dev) for _, t in self.shards])


def shard_rows(x, mesh: Mesh, axis="data") -> RowShards:
    """Cut the global rows of ``x`` (a tensor or host array) into
    ``mesh.axis_size(axis)`` equal shards (``axis``: one axis name or a
    tuple sharded jointly, outer axis major) and place this process's on their
    devices: a row view where ``x`` already lives on that device, a copy
    otherwise. A CUDA view must start on a 16-byte boundary (the kernels
    read their rows through tensor maps); this is asserted here, where the
    shard is cut."""
    if isinstance(x, RowShards):
        return x
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    n_shards = mesh.axis_size(axis)
    if t.shape[0] % n_shards:
        raise ValueError(f"{t.shape[0]} rows do not shard {n_shards} ways (pad to a multiple first)")
    shard_n = t.shape[0] // n_shards
    targets = {dev for _, dev in mesh.axis_shards(axis)}
    if mesh.process_count == 1 and len(targets) == 1:
        t = t.to(next(iter(targets)))  # one staged copy, every shard a view of it
    t = t.contiguous()
    row_bytes = t[0].numel() * t.element_size() if t.shape[0] else 0
    out = []
    for g, dev in mesh.axis_shards(axis):
        part = t[g * shard_n:(g + 1) * shard_n]
        if part.device == dev:
            if dev.type == "cuda" and row_bytes >= _TMA_ALIGN:
                assert part.data_ptr() % _TMA_ALIGN == 0, (
                    f"shard {g} of {tuple(t.shape)} starts at {part.data_ptr():#x}, not 16-byte aligned")
        else:
            part = part.to(dev)
        out.append((g, part))
    return RowShards(out, shard_n, n_shards, mesh, axis)


def replicate(x, mesh: Mesh) -> Dict[torch.device, torch.Tensor]:
    """One copy of ``x`` per distinct device of the mesh (the tensor itself
    on the device it already lives on)."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    out: Dict[torch.device, torch.Tensor] = {}
    for dev in mesh.local_devices:
        if dev not in out:
            out[dev] = t if t.device == dev else t.to(dev)
    return out


def all_gather_processes(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``[P * x.shape[0], ...]``: every process's ``x`` concatenated in
    process order, on ``x``'s device; ``x`` itself on a mesh of one process
    without ``torch.distributed``. Under gloo the tensors cross as CPU
    tensors (gloo gathers no CUDA tensor); under NCCL on the rank's card."""
    if mesh.group is None:
        return x
    import torch.distributed as dist

    nccl = dist.get_backend(mesh.group) == "nccl"
    src = (x.to(torch.device("cuda", torch.cuda.current_device())) if nccl else x.cpu()).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(x.device)


def gather_shard_outputs(outs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Per-shard outputs of this process (each ``[Q, ...]``, any device) ->
    ``[n_shards_global, Q, ...]`` on the mesh's first device, shard-major
    across processes."""
    dev = mesh.first_device
    local = torch.stack([o.to(dev) for o in outs])
    return all_gather_processes(local, mesh)


def host_local_batch_to_global(batch: Dict[str, Any], mesh: Mesh, axis=("data",)) -> Dict[str, RowShards]:
    """Each process's contiguous rows of a global batch (host arrays or
    tensors) cut into its data shards over ``axis`` (one name or a tuple of
    axes sharded jointly), shard *i* on its device: the port's
    ``jax.make_array_from_process_local_data``. The global batch is the
    process-major concatenation of the processes' rows."""
    axis = axis[0] if isinstance(axis, (tuple, list)) and len(axis) == 1 else axis
    shards = mesh.axis_shards(axis)
    n_global = mesh.axis_size(axis)
    out = {}
    for key, x in batch.items():
        t = x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
        if t.shape[0] % len(shards):
            raise ValueError(f"{key}: {t.shape[0]} local rows do not split into {len(shards)} data shards")
        n = t.shape[0] // len(shards)
        out[key] = RowShards([(g, t[j * n:(j + 1) * n].to(dev)) for j, (g, dev) in enumerate(shards)],
                             n, n_global, mesh, axis)
    return out


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[torch.device, Dict[str, torch.Tensor]]:
    """A parameter dict replicated over the mesh: one copy per distinct
    device (pure data parallelism; ``parallel.fsdp`` / ``parallel.tp`` cut
    parameters into blocks instead)."""
    return {dev: {n: (p if p.device == dev else p.to(dev)) for n, p in params.items()}
            for dev in dict.fromkeys(mesh.local_devices)}


def all_gather_autograd(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every process's ``x`` in process order, differentiably: the backward
    sums each part's cotangents over the processes and hands each process
    its own part's sum (JAX's ``all_gather`` transpose, ``psum_scatter``).
    ``[x]`` without a group. Under gloo the tensors cross as CPU tensors."""
    if group is None:
        return [x]
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_gather

    src = x.contiguous() if dist.get_backend(group) == "nccl" else x.cpu().contiguous()
    # the collectives of the backward read their buffers as contiguous: a
    # part's cotangent (a slice of a concatenation's) is made so first
    return [_ContiguousGrad.apply(p).to(x.device) for p in all_gather(src, group=group)]


class _ContiguousGrad(torch.autograd.Function):
    """The identity whose backward hands on a contiguous gradient."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


REDUCE_BUCKET_BYTES = 64 << 20  # the most one all-reduce of all_reduce_ sends


def all_reduce_(tensors: Sequence[torch.Tensor], group, op: str = "sum",
                dtype: Optional[torch.dtype] = None) -> None:
    """Sum (``op="sum"``) or maximum (``"max"``) of each tensor over the
    processes, in place; nothing without a group. The values cross in
    their own dtype (or ``dtype``, such as float64 for scalar metrics), in
    flat buckets of at most :data:`REDUCE_BUCKET_BYTES` (a larger tensor
    alone); under gloo the buckets are CPU tensors."""
    if group is None or not tensors:
        return
    import torch.distributed as dist

    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    nccl = dist.get_backend(group) == "nccl"
    dev = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")

    def flush(bucket, dt):
        flat = torch.cat([t.detach().reshape(-1).to(dev, dt) for t in bucket])
        dist.all_reduce(flat, op=red, group=group)
        i = 0
        for t in bucket:
            n = t.numel()
            t.copy_(flat[i:i + n].view(t.shape))
            i += n

    buckets: Dict[torch.dtype, Tuple[List[torch.Tensor], int]] = {}
    for t in tensors:
        dt = dtype or t.dtype
        bucket, size = buckets.get(dt, ([], 0))
        nbytes = t.numel() * dt.itemsize
        if bucket and size + nbytes > REDUCE_BUCKET_BYTES:
            flush(bucket, dt)
            bucket, size = [], 0
        buckets[dt] = (bucket + [t], size + nbytes)
    for dt, (bucket, _) in buckets.items():
        flush(bucket, dt)


class HopLog:
    """Messages sent, bytes and host seconds of the cross-process hops
    (``"p2p"``: :func:`exchange`) and reductions (``"reduce"``:
    :func:`sum_partials` / :func:`sum_gradients`) since :meth:`reset`;
    ``host_bytes`` is what crossed as CPU tensors (gloo). The seconds count
    the host's wait for the peer too (a receive waits for the other rank's
    stage), and under NCCL only the enqueue."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def add(self, kind: str, messages: int, nbytes: int, seconds: float, host: bool) -> None:
        with self._lock:
            entry = self._kinds.setdefault(kind, dict(messages=0, bytes=0, host_bytes=0, seconds=0.0))
            entry["messages"] += messages
            entry["bytes"] += nbytes
            entry["host_bytes"] += nbytes if host else 0
            entry["seconds"] += seconds

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._kinds.items()}

    def reset(self) -> None:
        with self._lock:
            self._kinds: Dict[str, Dict[str, float]] = {}


hop_log = HopLog()


def exchange(sends: Dict[int, Sequence[torch.Tensor]], recvs: Dict[int, Sequence[torch.Tensor]], group) -> None:
    """One round of point-to-point hops between the ranks of ``group``: the
    tensors of ``sends[r]`` go to rank ``r`` and the buffers of
    ``recvs[r]`` (any devices) are filled from rank ``r``, which sends
    tensors of the same shapes and dtypes in the same order. Each peer's
    tensors travel as one message of bytes, and every send is posted beside
    the receives in one ``dist.batch_isend_irecv`` and waited on (a blocking
    send before a receive on every rank can deadlock). Under gloo, whose
    send and receive take no CUDA tensor, the messages cross as CPU
    tensors; under NCCL they cross on the rank's card."""
    if not sends and not recvs:
        return
    import torch.distributed as dist

    t0 = time.perf_counter()
    nccl = dist.get_backend(group) == "nccl"
    dev = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    ops, landing, nbytes = [], [], 0
    for r, tensors in sends.items():
        flat = torch.cat([t.detach().contiguous().reshape(-1).view(torch.uint8).to(dev) for t in tensors])
        nbytes += flat.numel()
        ops.append(dist.P2POp(dist.isend, flat, dist.get_global_rank(group, r), group))
    for r, bufs in recvs.items():
        flat = torch.empty(sum(b.numel() * b.element_size() for b in bufs), dtype=torch.uint8, device=dev)
        landing.append((flat, bufs))
        ops.append(dist.P2POp(dist.irecv, flat, dist.get_global_rank(group, r), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    for flat, bufs in landing:
        offset = 0
        for b in bufs:
            n = b.numel() * b.element_size()
            b.copy_(flat[offset:offset + n].clone().view(b.dtype).view(b.shape))  # clone: an aligned start
            offset += n
    hop_log.add("p2p", len(sends), nbytes, time.perf_counter() - t0, not nccl)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (a new tensor on ``x``'s device)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    out = x.detach().clone()
    all_reduce_([out], group)
    hop_log.add("reduce", 1, out.numel() * out.element_size(), time.perf_counter() - t0,
                dist.get_backend(group) != "nccl")
    return out


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's partial ``x`` summed into the value each rank holds; the
    backward is the identity. Every rank computes the same loss from the
    summed (replicated) value, so each already holds its whole cotangent:
    summing it again, as ``torch.distributed.nn.functional.all_reduce``'s
    backward does, would scale the gradients by the number of ranks. ``x``
    itself without a group."""
    return x if group is None else _SumPartials.apply(x, group)


def sum_gradients(x: torch.Tensor, group) -> torch.Tensor:
    """The identity whose backward sums the gradients over the ranks of
    ``group``: put on a replicated value that each rank reads only a part
    of, it hands every rank the whole gradient. ``x`` itself without a
    group."""
    return x if group is None else _SumGradients.apply(x, group)


class BuiltGauge:
    """Bytes of the built parameters alive (each counts until the last
    reference to it goes: a weak reference) and the most alive at once
    since :meth:`reset`: what a step holds of its parameters above their
    blocks."""

    def __init__(self):
        self._lock = threading.RLock()
        self._alive: Dict[int, weakref.ref] = {}
        self.bytes = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        n, key = t.numel() * t.element_size(), id(t)

        def gone(_, key=key, n=n):
            with self._lock:
                if self._alive.pop(key, None) is not None:
                    self.bytes -= n

        with self._lock:
            self._alive[key] = weakref.ref(t, gone)
            self.bytes += n
            self.peak = max(self.peak, self.bytes)

    def reset(self) -> None:
        with self._lock:
            self.peak = self.bytes


Spec = Tuple[Any, ...]  # per dimension: None (whole) or the mesh axis the dimension is cut over


def _leaf(name: str, coord: Tuple[int, ...]) -> str:
    """A block's leaf name: ``name@i,j`` (its global block coordinates)."""
    return f"{name}@{','.join(map(str, coord))}"


class ShardedParams:
    """A parameter dict laid out on a mesh: each tensor cut into equal
    blocks along the dimensions its spec names (per dimension ``None`` or a
    mesh axis, as a JAX ``PartitionSpec``), each block of this process a
    leaf ``nn.Parameter`` on the device of the first position of this
    process that holds it (a block is replicated over the axes its spec
    does not name). Blocks along the mesh's leading axis live on the
    processes that own those coordinates; :meth:`gather` builds
    parameters from their blocks, across processes through
    :func:`all_gather_autograd`, so a backward pass leaves each block the
    sum of the gradients of its every use (FSDP's reduce-scatter).
    :attr:`gauge` counts the built tensors alive (a view shares it)."""

    def __init__(self, params: Dict[str, torch.Tensor], mesh: Mesh, specs: Dict[str, Spec],
                 requires_grad: bool = True):
        self.mesh = mesh
        self.specs = {n: tuple(specs[n]) + (None,) * (params[n].ndim - len(specs[n])) for n in params}
        self.shapes = {n: tuple(p.shape) for n, p in params.items()}
        self.dtypes = {n: p.dtype for n, p in params.items()}
        self.blocks: Dict[str, Dict[Tuple[int, ...], torch.nn.Parameter]] = {}
        self.gauge = BuiltGauge()
        self.holders: Dict[str, Dict[Tuple[int, ...], Tuple[int, ...]]] = {}
        lead = mesh.axis_names[0]
        for n, p in params.items():
            spec = self.specs[n]
            cut = [(d, a) for d, a in enumerate(spec) if a is not None]
            for d, a in cut:
                if p.shape[d] % mesh.shape[a]:
                    raise ValueError(f"{n}: dim {d} ({p.shape[d]}) does not split {mesh.shape[a]} ways over {a!r}")
            coords_of = [mesh.local_coords(a) if a == lead else list(range(mesh.shape[a])) for _, a in cut]
            self.blocks[n], self.holders[n] = {}, {}
            for coord in (tuple(c) for c in np.ndindex(*[len(c) for c in coords_of])):
                glob = tuple(coords_of[i][c] for i, c in enumerate(coord))
                pos = self._holder(spec, glob)
                block = p.detach()
                for (d, a), g in zip(cut, glob):
                    size = p.shape[d] // mesh.shape[a]
                    block = block.narrow(d, g * size, size)
                dev = mesh.devices[pos]
                leaf = torch.nn.Parameter(block.to(dev).clone(), requires_grad=requires_grad)
                self.blocks[n][glob] = leaf
                self.holders[n][glob] = pos

    def _holder(self, spec: Spec, glob: Tuple[int, ...]) -> Tuple[int, ...]:
        """The first local grid position whose coordinates on the spec's
        axes are ``glob``."""
        mesh = self.mesh
        cut = [a for a in spec if a is not None]
        for pos in np.ndindex(*mesh.devices.shape):
            g = list(pos)
            g[0] += mesh.process_index * mesh.devices.shape[0]
            if all(g[mesh.axis_names.index(a)] == c for a, c in zip(cut, glob)):
                return pos
        raise ValueError(f"no local position holds block {glob} of spec {spec}")

    def view(self, leaves: Dict[str, torch.Tensor]) -> "ShardedParams":
        """The same layout over other blocks of the same shapes (an EMA
        shadow, by leaf name)."""
        out = object.__new__(ShardedParams)
        out.__dict__.update(self.__dict__)
        out.blocks = {n: {c: leaves[_leaf(n, c)] for c in blocks}
                      for n, blocks in self.blocks.items()}
        return out

    def leaves(self) -> Dict[str, torch.nn.Parameter]:
        """Every block of this process by ``name@i,j`` (its global block coordinates)."""
        return {_leaf(n, c): b for n, blocks in self.blocks.items() for c, b in blocks.items()}

    @staticmethod
    def base_name(leaf_name: str) -> str:
        return leaf_name.split("@", 1)[0]

    def spans_processes(self, name: str) -> bool:
        """True when ``name``'s blocks differ between processes (cut over the leading axis)."""
        return self.mesh.process_count > 1 and self.mesh.axis_names[0] in self.specs[name]

    def gather(self, requests: Sequence[Tuple[str, Optional[int]]], device,
               keep: Optional[str] = None) -> List[torch.Tensor]:
        """Parameters built on ``device`` from their blocks, in autograd (a
        backward pass leaves each block the sum of its every use): per
        request ``(name, m)`` the whole parameter (``m`` None) or, with
        ``keep`` an axis its spec names, its block ``m`` along that axis,
        assembled over its other cut dimensions. Blocks on other processes
        cross in one flat all-gather per dtype for all the requests. Each
        built tensor (not a block itself) counts in :attr:`gauge` while it
        lives."""
        dev = torch.device(device)
        lead = self.mesh.axis_names[0]
        multi = self.mesh.process_count > 1
        out: List[Optional[torch.Tensor]] = [None] * len(requests)
        crossing: Dict[torch.dtype, list] = {}
        for i, (name, m) in enumerate(requests):
            cut = [(d, a) for d, a in enumerate(self.specs[name]) if a is not None]
            blocks = self.blocks[name]
            if m is not None:
                k = [a for _, a in cut].index(keep)
                blocks = {c[:k] + c[k + 1:]: b for c, b in blocks.items() if c[k] == m}
                cut = cut[:k] + cut[k + 1:]
            t = self._assemble(blocks, (), cut, dev, local=True)
            d = next((d for d, a in cut if a == lead), None) if multi else None
            if d is not None:
                crossing.setdefault(t.dtype, []).append((i, t, d))
                continue
            out[i] = t
            if cut or t is not blocks[()]:
                self.gauge.add(t)
        for items in crossing.values():
            parts = all_gather_autograd(torch.cat([t.reshape(-1) for _, t, _ in items]), self.mesh.group)
            offset = 0
            for i, t, d in items:
                n = t.numel()
                out[i] = torch.cat([p[offset:offset + n].view(t.shape) for p in parts], dim=d)
                offset += n
                self.gauge.add(out[i])
        return out

    def _assemble(self, blocks, prefix, cut, dev, local: bool = False) -> torch.Tensor:
        """Concatenate ``blocks`` (by coordinates) over the dims of ``cut``
        on ``dev``: across processes along the leading axis, or with
        ``local`` only this process's coordinates of it."""
        if not cut:
            return blocks[prefix].to(dev)
        (d, a), rest = cut[0], cut[1:]
        mesh = self.mesh
        if a == mesh.axis_names[0] and mesh.process_count > 1:
            mine = torch.cat([self._assemble(blocks, prefix + (i,), rest, dev, local) for i in mesh.local_coords(a)],
                             dim=d)
            return mine if local else torch.cat(all_gather_autograd(mine, mesh.group), dim=d)
        return torch.cat([self._assemble(blocks, prefix + (i,), rest, dev, local) for i in range(mesh.shape[a])],
                         dim=d)

    def full(self, name: str, tensors: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """The whole parameter (or, given ``tensors`` by leaf name, the
        same-shaped blocks such as moments) as one CPU tensor, gathered over
        the processes without autograd: every process must call it."""
        src = tensors if tensors is not None else self.leaves()
        blocks = {c: src[_leaf(name, c)].detach() for c in self.blocks[name]}
        cut = [(d, a) for d, a in enumerate(self.specs[name]) if a is not None]
        with torch.no_grad():
            return self._assemble(blocks, (), cut, self.mesh.first_device).cpu()

    def whole(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Tensors keyed by leaf name (blocks, or same-shaped moments) as
        whole CPU tensors by parameter name (every process calls it)."""
        names = dict.fromkeys(self.base_name(n) for n in leaves)
        return {n: self.full(n, leaves) for n in names}

    def load_whole(self, whole: Dict[str, torch.Tensor], into: Dict[str, torch.Tensor]) -> None:
        """Copy whole tensors by parameter name into the leaf-named ``into``."""
        for n in dict.fromkeys(self.base_name(k) for k in into):
            self.load_full(n, whole[n], into=into)

    def load_full(self, name: str, value: torch.Tensor, into: Optional[Dict[str, torch.Tensor]] = None) -> None:
        """Copy the blocks of a whole ``value`` into this process's blocks
        (or into ``into``'s same-named tensors)."""
        spec = self.specs[name]
        cut = [(d, a) for d, a in enumerate(spec) if a is not None]
        dst = into if into is not None else self.leaves()
        with torch.no_grad():
            for c in self.blocks[name]:
                block = value
                for (d, a), g in zip(cut, c):
                    size = value.shape[d] // self.mesh.shape[a]
                    block = block.narrow(d, g * size, size)
                dst[_leaf(name, c)].copy_(block)

    def position_bytes(self, extra: Optional[Dict[str, Sequence[torch.Tensor]]] = None) -> List[int]:
        """Bytes each local grid position holds (row-major): its blocks and,
        given ``extra`` (leaf name -> tensors such as the AdamW moments),
        those too."""
        out = [0] * self.mesh.devices.size
        shape = self.mesh.devices.shape
        for n, blocks in self.blocks.items():
            for c, b in blocks.items():
                leaf = _leaf(n, c)
                size = b.numel() * b.element_size() + sum(
                    t.numel() * t.element_size() for t in (extra or {}).get(leaf, ()))
                out[int(np.ravel_multi_index(self.holders[n][c], shape))] += size
        return out
