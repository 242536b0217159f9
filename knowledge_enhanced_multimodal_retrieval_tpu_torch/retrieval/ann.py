"""IVF approximate-nearest-neighbor index: sublinear corpus probing.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/retrieval/ann.py``
(plain XLA there, plain PyTorch here: no Pallas kernel on this path).

- **Spherical k-means** on the concatenated ``[img ; txt]`` rows, so one
  index serves every runtime blend alpha; farthest-point seeding.
- **Cluster-major packed storage with a fixed capacity** per cluster
  (``[nlist, cap, D]``), rows that overflow a full cluster spill to their
  next-best one; exact, int8, int4 (nibble planes) or residual PQ lists.
- **Search**: centroid scores -> top-``nprobe`` -> gather the probed
  clusters -> blended scores -> top-k with ``-1`` / ``-inf`` sentinels where
  fewer than k rows were probed. Top-k selections order ties by position, as
  ``jax.lax.top_k`` does (a stable sort).

- **Sharded search** (:func:`sharded_ivf_search`): the index shards by
  cluster over a mesh axis (:func:`shard_ivf_index`); each shard probes its
  own best ``ceil(nprobe / n)`` clusters, so the probe set is the best per
  shard rather than the global top ``nprobe`` (``nprobe == nlist`` still
  probes every cluster), and the ``[Q, k]`` winners merge. ``packed_rows``
  hold global row ids, so the merge needs no offsets.

The ``.npz`` of :func:`save_ivf_index` / :func:`load_ivf_index` is the JAX
package's format, fingerprint and all: an index built by either package
loads in the other. The first k-means seed row is drawn from a
``torch.Generator`` (the JAX package draws it from ``jax.random``), so the
two packages build different indexes from the same seed.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops.pq import pq_encode_host, pq_luts, train_pq_codebooks
from ..ops.similarity import (
    _merge_shard_winners,
    _unpack_q4,
    alpha_column,
    quantize_corpus_host,
    quantize_corpus_host_q4,
)

_SUBLANE = 8  # the packed cap axis rounds up to this multiple (the JAX format's)


def _stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _maxmin_init(x: torch.Tensor, nlist: int, first: int) -> torch.Tensor:
    """Farthest-point seeding from row ``first``: each next seed is the row
    with the LOWEST max cosine similarity to the chosen set."""
    xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-9)
    cent = torch.zeros((nlist, x.shape[1]), dtype=torch.float32, device=x.device)
    cent[0] = xn[first]
    max_sim = xn @ xn[first]
    for i in range(1, nlist):
        c = xn[torch.argmin(max_sim)]
        cent[i] = c
        max_sim = torch.maximum(max_sim, xn @ c)
    return cent


def kmeans_spherical(x, nlist: int, iters: int = 10, seed: int = 0, init: str = "maxmin") -> torch.Tensor:
    """Spherical k-means: L2-normalized centroids ``[nlist, D]`` on ``x``'s
    device. Empty clusters keep their previous centroid. The first seed row
    (``maxmin``) or the seed sample (``random``) comes from a
    ``torch.Generator`` seeded with ``seed``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n = x.shape[0]
    if nlist > n:
        raise ValueError(f"nlist {nlist} > rows {n}")
    if init not in ("maxmin", "random"):
        raise ValueError(f"unknown init {init!r}: expected 'maxmin' or 'random'")
    gen = torch.Generator().manual_seed(seed)
    if init == "maxmin":
        c = _maxmin_init(x, nlist, int(torch.randint(n, (), generator=gen)))
    else:
        c = x[torch.randperm(n, generator=gen)[:nlist].to(x.device)]
        c = c / torch.clamp(torch.linalg.vector_norm(c, dim=1, keepdim=True), min=1e-9)
    for _ in range(iters):
        assign = torch.argmax(x @ c.T, dim=1)
        onehot = torch.nn.functional.one_hot(assign, nlist).to(torch.float32)  # [N, nlist]
        sums = onehot.T @ x
        counts = onehot.sum(0)[:, None]
        c_new = torch.where(counts > 0, sums, c)
        c = c_new / torch.clamp(torch.linalg.vector_norm(c_new, dim=1, keepdim=True), min=1e-9)
    return c


def _pack_with_spill(pref: np.ndarray, nlist: int, cap: int) -> np.ndarray:
    """Greedy cluster packing by preference round (the JAX package's code).

    ``pref`` [N, nlist] = cluster ids sorted best-first per row. Round ``j``
    lets every still-unassigned row claim a free slot in its ``j``-th-choice
    cluster (earlier rows win ties within a round); leftovers spill to round
    ``j+1``. Returns ``packed_rows`` [nlist, cap] int32 with -1 padding;
    every row indexed exactly once while total capacity >= N.
    """
    n = pref.shape[0]
    if nlist * cap < n:
        raise ValueError(f"capacity {nlist}x{cap} < rows {n}")
    packed = np.full((nlist, cap), -1, np.int64)
    fill = np.zeros(nlist, np.int64)
    unassigned = np.arange(n)
    for j in range(nlist):
        if unassigned.size == 0:
            break
        choice = pref[unassigned, j]  # j-th choice of each leftover row
        order = np.argsort(choice, kind="stable")  # groups rows by cluster,
        rows = unassigned[order]  # preserving row order within a cluster
        choice = choice[order]
        # rank of each row within its cluster's claimants this round
        first = np.searchsorted(choice, choice, side="left")
        rank = np.arange(rows.size) - first
        free = cap - fill[choice]
        take = rank < free
        c_taken, r_taken = choice[take], rows[take]
        packed[c_taken, fill[c_taken] + rank[take]] = r_taken
        fill += np.bincount(c_taken, minlength=nlist)
        unassigned = rows[~take]
    if unassigned.size:  # pragma: no cover — impossible while capacity >= n
        raise RuntimeError("no free slot found")
    return packed.astype(np.int32)


@dataclasses.dataclass
class IVFIndex:
    """Packed two-tower IVF index (tensors on one device).

    With ``packed_*_scale`` set and no codebooks, ``packed_img``/``packed_txt``
    hold symmetric per-row int8, or nibble-packed int4 when their last axis
    is ``D/2``. With ``cb_img``/``cb_txt`` set (IVF-PQ), they hold uint8
    codes ``[nlist, cap, M]`` of the residual to the owning centroid, and
    the scales the residual norms.
    """

    centroids_img: torch.Tensor  # [nlist, D] f32
    centroids_txt: torch.Tensor  # [nlist, D] f32
    packed_img: torch.Tensor  # [nlist, cap, D] (f32/bf16/int8), [nlist, cap, D/2] int4 or [nlist, cap, M] uint8
    packed_txt: torch.Tensor
    packed_rows: torch.Tensor  # [nlist, cap] int32, -1 = empty slot
    spill_fraction: float  # diagnostic: rows not in their best cluster
    packed_img_scale: Optional[torch.Tensor] = None  # [nlist, cap] f32 per-row scales
    packed_txt_scale: Optional[torch.Tensor] = None
    cb_img: Optional[torch.Tensor] = None  # [M, K, ds] f32 PQ codebooks (pq mode)
    cb_txt: Optional[torch.Tensor] = None

    @property
    def nlist(self) -> int:
        return self.packed_rows.shape[0]

    @property
    def cap(self) -> int:
        return self.packed_rows.shape[1]

    @property
    def is_pq(self) -> bool:
        return self.cb_img is not None

    @property
    def is_int4(self) -> bool:
        """Nibble-packed int4 tiles: the packed last axis is D/2."""
        return (
            self.packed_img_scale is not None
            and self.cb_img is None
            and self.packed_img.shape[-1] * 2 == self.centroids_img.shape[-1]
        )

    @property
    def quantized(self) -> bool:
        """int8-packed tiles (per-row scales, no codebooks, full width)."""
        return self.packed_img_scale is not None and self.cb_img is None and not self.is_int4

    @property
    def mode(self) -> str:
        if self.is_pq:
            return "pq"
        if self.is_int4:
            return "int4"
        return "int8" if self.quantized else "exact"

    def to(self, device) -> "IVFIndex":
        move = lambda t: None if t is None else t.to(device)  # noqa: E731
        return dataclasses.replace(
            self, **{f.name: move(getattr(self, f.name)) for f in dataclasses.fields(self)
                     if f.name != "spill_fraction"}
        )


def build_ivf_index(
    image: np.ndarray,
    text: np.ndarray,
    nlist: int,
    *,
    capacity_factor: float = 1.5,
    iters: int = 10,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    quantize: Optional[str] = None,
    train_rows: Optional[int] = None,
    kmeans_init: str = "maxmin",
    pq_m: Optional[int] = None,
    device="cpu",
) -> IVFIndex:
    """Cluster the corpus and pack it cluster-major (the JAX package's
    ``build_ivf_index``; k-means runs on ``device``, packing on the host).

    ``quantize``: None (exact rows in ``dtype``), ``"int8"``, ``"int4"``
    (the flat int8/int4 corpus quantizers, bit for bit) or ``"pq"``
    (residual IVF-PQ: codes model ``x - c(owning cluster)``; ``pq_m``
    subspaces, default D/8). ``capacity_factor`` sizes each cluster at
    ``factor * N / nlist`` slots, rounded up to a multiple of 8.
    """
    n, d = image.shape
    if text.shape != image.shape:
        raise ValueError(f"tower shape mismatch: {image.shape} vs {text.shape}")
    if quantize not in (None, "int8", "int4", "pq"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    img_np, txt_np = np.asarray(image, np.float32), np.asarray(text, np.float32)
    xc_np = np.concatenate([img_np, txt_np], axis=1)
    if train_rows is not None and train_rows < n:
        train = xc_np[np.random.default_rng(seed).choice(n, train_rows, replace=False)]
    else:
        train = xc_np
    cent = kmeans_spherical(torch.from_numpy(train).to(device), nlist, iters=iters, seed=seed, init=kmeans_init)
    cent = cent.cpu().numpy()

    # host-side packing: per-row cluster preference (best-first), greedy spill
    scores = xc_np @ cent.T  # [N, nlist]
    pref = np.argsort(-scores, axis=1)
    cap = int(np.ceil(capacity_factor * n / nlist))
    cap = max(_SUBLANE, -(-cap // _SUBLANE) * _SUBLANE)
    while nlist * cap < n:
        cap += _SUBLANE
    packed_rows = _pack_with_spill(pref, nlist, cap)
    best = pref[:, 0]
    row_cluster = np.empty(n, np.int64)
    for c in range(nlist):
        members = packed_rows[c][packed_rows[c] >= 0]
        row_cluster[members] = c
    spill_fraction = float(np.mean(row_cluster != best)) if n else 0.0

    gather = np.where(packed_rows >= 0, packed_rows, 0)
    zero_mask = (packed_rows < 0)[..., None]
    img_scale = txt_scale = None
    cb_i = cb_t = None
    if quantize == "pq":
        # residual encoding against the OWNING (packed) cluster; empty slots
        # pack to scale 0 and the row sentinel masks their centroid term
        m = pq_m or max(1, d // 8)
        half_i, half_t = cent[:, :d], cent[:, d:]
        res_i = np.where(zero_mask, 0.0, img_np[gather] - half_i[:, None, :])
        res_t = np.where(zero_mask, 0.0, txt_np[gather] - half_t[:, None, :])
        live = (packed_rows >= 0).ravel()
        cb_i = train_pq_codebooks(res_i.reshape(-1, d)[live], m=m)
        cb_t = train_pq_codebooks(res_t.reshape(-1, d)[live], m=m)
        img_c, img_s = pq_encode_host(res_i.reshape(-1, d), cb_i)
        txt_c, txt_s = pq_encode_host(res_t.reshape(-1, d), cb_t)
        packed_img = img_c.reshape(nlist, cap, m)
        packed_txt = txt_c.reshape(nlist, cap, m)
        img_scale = np.where(packed_rows < 0, 0.0, img_s[:, 0].reshape(nlist, cap)).astype(np.float32)
        txt_scale = np.where(packed_rows < 0, 0.0, txt_s[:, 0].reshape(nlist, cap)).astype(np.float32)
        pack_dtype = torch.uint8
    elif quantize in ("int8", "int4"):
        quant_fn = quantize_corpus_host if quantize == "int8" else quantize_corpus_host_q4
        img_q, img_s = quant_fn(img_np)
        txt_q, txt_s = quant_fn(txt_np)
        packed_img = np.where(zero_mask, np.int8(0), img_q[gather])
        packed_txt = np.where(zero_mask, np.int8(0), txt_q[gather])
        img_scale = np.where(packed_rows < 0, 0.0, img_s[:, 0][gather]).astype(np.float32)
        txt_scale = np.where(packed_rows < 0, 0.0, txt_s[:, 0][gather]).astype(np.float32)
        pack_dtype = torch.int8
    else:
        packed_img = np.where(zero_mask, 0.0, img_np[gather]).astype(np.float32)
        packed_txt = np.where(zero_mask, 0.0, txt_np[gather]).astype(np.float32)
        pack_dtype = dtype

    put = lambda a, dt=None: torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dt)  # noqa: E731
    return IVFIndex(
        centroids_img=put(cent[:, :d]),
        centroids_txt=put(cent[:, d:]),
        packed_img=put(packed_img, pack_dtype),
        packed_txt=put(packed_txt, pack_dtype),
        packed_rows=put(packed_rows),
        spill_fraction=spill_fraction,
        packed_img_scale=None if img_scale is None else put(img_scale),
        packed_txt_scale=None if txt_scale is None else put(txt_scale),
        cb_img=None if cb_i is None else put(cb_i),
        cb_txt=None if cb_t is None else put(cb_t),
    )


def ivf_search(queries: torch.Tensor, index: IVFIndex, *, k: int, nprobe: int, alpha=0.5
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe the top-``nprobe`` clusters; return ``(values, row_ids)``:
    blended scores ``a * (q . img) + (1 - a) * (q . txt)`` of the probed
    rows, descending, with row id ``-1`` (value ``-inf``) where fewer than
    ``k`` rows were probed. The arithmetic of each list mode is the JAX
    package's: int8/int4 dots at the query dtype with the per-row scales on
    the score columns; IVF-PQ adds the probed centroid's dot to the residual
    ADC walk over bf16 LUTs (f32 sums in subspace order)."""
    nlist = index.nlist
    if not 1 <= nprobe <= nlist:
        raise ValueError(f"nprobe {nprobe} out of range [1, {nlist}]")
    b = queries.shape[0]
    a = alpha_column(alpha, b, queries.device)  # [B, 1] f32
    compute_dtype = index.packed_img.dtype if index.mode == "exact" else queries.dtype
    q = queries.to(compute_dtype)
    cs_i = (q @ index.centroids_img.to(q.dtype).T).float()
    cs_t = (q @ index.centroids_txt.to(q.dtype).T).float()
    cs = a * cs_i + (1.0 - a) * cs_t
    _, probe = _stable_topk(cs, nprobe)  # [B, nprobe]

    rows = index.packed_rows[probe]  # [B, nprobe, cap]
    a3 = a[:, :, None]  # [B, 1, 1] over (probe, cap)
    if index.is_pq:
        p_rows = nprobe * index.cap
        qf = q.float()

        def adc(packed_codes, cb, scale, cs_tower):
            lut = pq_luts(qf, cb)  # [M, B, K] bf16
            codes = packed_codes[probe].reshape(b, p_rows, -1).long()  # [B, P, M]
            acc = torch.zeros((b, p_rows), dtype=torch.float32, device=q.device)
            for mm in range(lut.shape[0]):
                acc = acc + torch.gather(lut[mm].float(), 1, codes[:, :, mm])
            s = scale[probe].reshape(b, p_rows)
            coarse = torch.gather(cs_tower, 1, probe)  # [B, nprobe]: q . c of the probed cluster
            return (acc * s).reshape(b, nprobe, index.cap) + coarse[:, :, None]

        s = a3 * adc(index.packed_img, index.cb_img, index.packed_img_scale, cs_i) + (1.0 - a3) * adc(
            index.packed_txt, index.cb_txt, index.packed_txt_scale, cs_t
        )
    elif index.is_int4:
        d2 = index.packed_img.shape[-1]
        q_lo, q_hi = q[:, :d2], q[:, d2:]

        def q4_scores(packed):
            lo, hi = _unpack_q4(packed[probe], q.dtype)  # [B, nprobe, cap, D/2] each
            return (torch.einsum("bd,bpcd->bpc", q_lo, lo) + torch.einsum("bd,bpcd->bpc", q_hi, hi)).float()

        s_img = q4_scores(index.packed_img) * index.packed_img_scale[probe]
        s_txt = q4_scores(index.packed_txt) * index.packed_txt_scale[probe]
        s = a3 * s_img + (1.0 - a3) * s_txt
    elif index.quantized:
        pi, pt = index.packed_img[probe], index.packed_txt[probe]  # [B, nprobe, cap, D]
        s_img = torch.einsum("bd,bpcd->bpc", q, pi.to(q.dtype)).float() * index.packed_img_scale[probe]
        s_txt = torch.einsum("bd,bpcd->bpc", q, pt.to(q.dtype)).float() * index.packed_txt_scale[probe]
        s = a3 * s_img + (1.0 - a3) * s_txt
    else:
        pi, pt = index.packed_img[probe], index.packed_txt[probe]
        a3 = a3.to(pi.dtype)
        s = a3 * torch.einsum("bd,bpcd->bpc", q, pi) + (1.0 - a3) * torch.einsum("bd,bpcd->bpc", q, pt)
    s = torch.where(rows >= 0, s.float(), torch.full_like(s, -float("inf"), dtype=torch.float32))
    flat_s = s.reshape(b, -1)
    flat_rows = rows.reshape(b, -1)
    kk = min(k, flat_s.shape[1])
    vals, pos = _stable_topk(flat_s, kk)
    ids = torch.gather(flat_rows, 1, pos)
    ids = torch.where(torch.isfinite(vals), ids, torch.full_like(ids, -1))
    if kk < k:  # pad to the requested k (tiny-index edge)
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=-float("inf"))
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return vals, ids


_SHARDED_FIELDS = ("centroids_img", "centroids_txt", "packed_img", "packed_txt", "packed_rows",
                   "packed_img_scale", "packed_txt_scale")


@dataclasses.dataclass(eq=False)
class ShardedIVFIndex:
    """An IVF index cluster-sharded over one mesh axis: this process's
    shards as ``(shard index, IVFIndex of nlist / n clusters on its device)``
    (the codebooks replicate)."""

    shards: List[Tuple[int, IVFIndex]]
    n_shards: int
    nlist: int
    cap: int
    mesh: object
    axis: str


def shard_ivf_index(index: IVFIndex, mesh, axis: str = "data") -> ShardedIVFIndex:
    """Cut ``index`` into ``mesh.shape[axis]`` contiguous cluster ranges and
    place this process's on their devices (views where the index already
    lives there)."""
    from ..parallel.sharding import shard_rows

    n = mesh.shape[axis]
    if index.nlist % n:
        raise ValueError(f"nlist {index.nlist} does not shard {n} ways (a multiple of the axis size is needed)")
    cut = {f: shard_rows(getattr(index, f), mesh, axis) for f in _SHARDED_FIELDS if getattr(index, f) is not None}
    shards = []
    for j, (g, dev) in enumerate(mesh.axis_shards(axis)):
        parts = {f: c.shards[j][1] for f, c in cut.items()}
        cbs = {f: getattr(index, f).to(dev) for f in ("cb_img", "cb_txt") if getattr(index, f) is not None}
        shards.append((g, dataclasses.replace(index, **parts, **cbs)))
    return ShardedIVFIndex(shards, n, index.nlist, index.cap, mesh, axis)


def sharded_ivf_search(queries: torch.Tensor, index, *, k: int, nprobe: int, mesh, alpha=0.5, axis: str = "data"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF probe over an index cluster-sharded on ``axis`` (an
    :class:`IVFIndex`, cut here, or a :class:`ShardedIVFIndex`): each shard
    probes its best ``ceil(nprobe / n)`` clusters with :func:`ivf_search` at
    ``k_local = min(k, clusters x cap)``, the winners gather shard-major, and
    the final top-k pads with ``-inf`` / ``-1`` to ``k``."""
    from ..parallel.sharding import gather_shard_outputs

    sh = index if isinstance(index, ShardedIVFIndex) else shard_ivf_index(index, mesh, axis)
    nlist_local = sh.nlist // sh.n_shards
    nprobe_local = min(-(-nprobe // sh.n_shards), nlist_local)
    k_local = min(k, nlist_local * sh.cap)
    b = queries.shape[0]
    a = alpha_column(alpha, b, queries.device)
    vals, ids = [], []
    for _, li in sh.shards:
        dev = li.packed_rows.device
        v, i = ivf_search(queries.to(dev), li, k=k_local, nprobe=nprobe_local, alpha=a.to(dev))
        vals.append(v.float())
        ids.append(i)
    all_v, all_i = gather_shard_outputs(vals, sh.mesh), gather_shard_outputs(ids, sh.mesh)
    kk = min(k, all_v.shape[0] * all_v.shape[2])
    best_v, best_i = _merge_shard_winners(all_v, all_i, kk)
    best_i = torch.where(torch.isfinite(best_v), best_i, torch.full_like(best_i, -1))
    if kk < k:
        best_v = torch.nn.functional.pad(best_v, (0, k - kk), value=-float("inf"))
        best_i = torch.nn.functional.pad(best_i, (0, k - kk), value=-1)
    return best_v, best_i


def corpus_fingerprint(image, text) -> str:
    """Content fingerprint binding an index to ITS corpus (the JAX
    package's: shapes, float64 per-row sums and a strided raw-byte sample)."""
    h = hashlib.sha1()
    for arr in (image, text):
        arr = np.ascontiguousarray(np.asarray(arr, np.float32))
        h.update(str(arr.shape).encode())
        h.update(arr.sum(axis=1, dtype=np.float64).tobytes())
        stride = max(1, arr.shape[0] // 64)
        h.update(arr[::stride].tobytes())
    return h.hexdigest()


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor as the numpy array the file stores (bf16 rows are written
    as f32, exactly: numpy has no bf16)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save_ivf_index(path: str, index: IVFIndex, fingerprint: Optional[str] = None) -> None:
    """Persist a built index as one ``.npz`` in the JAX package's format,
    atomically (temp file + rename). ``fingerprint`` (from
    :func:`corpus_fingerprint`) lets :func:`load_ivf_index` refuse an index
    built for a different corpus."""
    if not str(path).endswith(".npz"):
        # np.savez appends ".npz" to bare paths, which would desync the
        # cache's existence check from the file actually written
        raise ValueError(f"index path must end with .npz, got {path!r}")
    arrays = {}
    if fingerprint is not None:
        arrays["fingerprint"] = np.frombuffer(fingerprint.encode(), np.uint8)
    arrays |= {
        "centroids_img": _host(index.centroids_img),
        "centroids_txt": _host(index.centroids_txt),
        "packed_img": _host(index.packed_img),
        "packed_txt": _host(index.packed_txt),
        "packed_rows": _host(index.packed_rows),
        "spill_fraction": np.float32(index.spill_fraction),
    }
    if index.packed_img_scale is not None:
        arrays["packed_img_scale"] = _host(index.packed_img_scale)
        arrays["packed_txt_scale"] = _host(index.packed_txt_scale)
    if index.is_pq:
        arrays["cb_img"] = _host(index.cb_img)
        arrays["cb_txt"] = _host(index.cb_txt)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_ivf_index(path: str, device="cpu", expected_fingerprint: Optional[str] = None) -> IVFIndex:
    """Load a :func:`save_ivf_index` artifact (from either package) onto
    ``device``. ``expected_fingerprint`` rejects an index built for a
    different corpus (or saved without one)."""
    with np.load(path) as data:
        if expected_fingerprint is not None:
            got = bytes(data["fingerprint"]).decode() if "fingerprint" in data else None
            if got != expected_fingerprint:
                raise ValueError(
                    f"index fingerprint mismatch for {path!r}: the index was "
                    "built for a different corpus (rebuild it)"
                )
        put = lambda key: torch.from_numpy(np.ascontiguousarray(data[key])).to(device)  # noqa: E731
        scaled = "packed_img_scale" in data
        is_pq = "cb_img" in data
        return IVFIndex(
            centroids_img=put("centroids_img"),
            centroids_txt=put("centroids_txt"),
            packed_img=put("packed_img"),
            packed_txt=put("packed_txt"),
            packed_rows=put("packed_rows"),
            spill_fraction=float(data["spill_fraction"]),
            packed_img_scale=put("packed_img_scale") if scaled else None,
            packed_txt_scale=put("packed_txt_scale") if scaled else None,
            cb_img=put("cb_img") if is_pq else None,
            cb_txt=put("cb_txt") if is_pq else None,
        )


def calibrate_nprobe(
    index: IVFIndex,
    queries,
    image,
    text,
    *,
    k: int = 10,
    alpha: float = 0.5,
    target_recall: float = 0.95,
    search_fn=None,
) -> dict:
    """The smallest ``nprobe`` (of 1, 2, 4, ... nlist) whose recall@k
    against the exact f32 host ranking meets ``target_recall``. Returns
    ``{"nprobe", "achieved", "report": [{"nprobe", "recall"}, ...]}``;
    ``nprobe`` falls back to ``nlist`` (an exact probe) when the sweep
    misses. ``search_fn(q, k, nprobe)`` overrides the probe (default:
    :func:`ivf_search` on the index's device)."""
    q = np.asarray(queries, np.float32)
    image = np.asarray(image, np.float32)
    text = np.asarray(text, np.float32)
    n = image.shape[0]
    k = min(k, n)
    s = alpha * q @ image.T + (1.0 - alpha) * q @ text.T
    exact = np.argpartition(-s, kth=k - 1, axis=1)[:, :k]  # order-free: recall is a set metric

    if search_fn is None:

        def search_fn(qq, kk, nprobe):
            qt = torch.from_numpy(np.asarray(qq, np.float32)).to(index.packed_rows.device)
            return ivf_search(qt, index, k=kk, nprobe=nprobe, alpha=alpha)

    sweep = []
    p = 1
    while True:
        sweep.append(min(p, index.nlist))
        if sweep[-1] >= index.nlist:
            break
        p *= 2

    exact_sets = [set(row.tolist()) for row in exact]
    report = []
    chosen = None
    for nprobe in sweep:
        _, ids = search_fn(q, k, nprobe)
        ids = ids.cpu().numpy() if torch.is_tensor(ids) else np.asarray(ids)
        hits = sum(len(exact_sets[i] & set(r[r >= 0].tolist())) for i, r in enumerate(ids))
        recall = hits / (len(exact_sets) * k) if exact_sets else 1.0
        report.append({"nprobe": int(nprobe), "recall": float(recall)})
        if recall >= target_recall:
            chosen = int(nprobe)
            break
    if chosen is None:
        chosen = index.nlist  # exact probe: always meets any target
    return {"nprobe": chosen, "achieved": report[-1]["recall"], "report": report}


def probed_fraction(index: IVFIndex, nprobe: int, n_rows: Optional[int] = None) -> float:
    """Fraction of the (padded) corpus one query reads."""
    total = index.nlist * index.cap if n_rows is None else n_rows
    return min(1.0, nprobe * index.cap / max(1, total))
