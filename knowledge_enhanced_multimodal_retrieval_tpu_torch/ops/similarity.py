"""Blended two-tower similarity + top-k: the retrieval scan.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/ops/similarity.py``
for the exact, int8 and int4 corpus modes:

    scores = alpha * (Q @ IMG^T) + (1 - alpha) * (Q @ TXT^T);  top-k(scores)

:func:`fused_similarity_topk` / :func:`fused_similarity_topk_q8` /
:func:`fused_similarity_topk_q4` launch the kernel B2
(``csrc/similarity.cu``) on CUDA tensors and run the plain version on CPU
tensors. Selection semantics are the TPU kernel's: pad and
NaN scores become float32 min, ties go to the lowest corpus row, and a
query with fewer than k finite scores is filled with (float32 min, row 0).
On the CPU, k > 128 takes the segmented exact selection over plain scores,
as JAX does above its kernel's cap; a CUDA tensor launches the kernel at
every k: its running lists carry up to ``KERNEL_PASS_K`` = 512 rows a pass,
and a larger k runs as passes under a ceiling (:func:`topk_passes`).

The masked (filtered) top-k at the end of the module is plain PyTorch on
every device, as it is plain XLA in the JAX package. The mesh-sharded scans
after it (``sharded_similarity_topk{,_q8,_q4}``,
``sharded_masked_similarity_topk``) run the one-device route on each row
shard and merge the winners.

Also here, as in JAX, the host helpers the capacity tiers share: the
Matryoshka prefix renormalization, the seeded random rotation and the exact
f32 host rerank of fetched candidates.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import dispatch
from .dispatch import I, P

_NEG_INF = float(np.finfo(np.float32).min)
_SEGMENTED_K = 128  # above it the CPU route selects as JAX does past its kernel's cap
KERNEL_PASS_K = 512  # the most rows one kernel pass selects (csrc/topk.cuh TOPK_KL)
_SMEM_LIST_K = 128  # up to it the kernels' running lists sit in shared memory (TOPK_SMEM_K)
_TILE = 128  # corpus rows per kernel tile (csrc/similarity.cu TK_T)
_F32_QUERY_GROUP = 16  # queries per block on the f32 route (TK_QG)
_F32_BLOCKS_PER_SM = 3  # f32-route blocks that fit an SM (about 70 KB of shared memory each at D = 768)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_Q4_CODE = 3  # nibble-packed int4 corpus rows (int8 [N, D/2])


def alpha_column(alpha, n_queries: int, device) -> torch.Tensor:
    """A scalar or per-query blend weight as an f32 ``[Q, 1]`` column on
    ``device``, made without waiting for a card: a scalar is filled there,
    host values reach it through pinned memory, and a tensor already there
    passes as it is."""
    if not torch.is_tensor(alpha) and np.ndim(alpha) == 0:
        return torch.full((n_queries, 1), float(alpha), dtype=torch.float32, device=device)
    a = dispatch.to_device(torch.as_tensor(alpha, dtype=torch.float32), device)
    if a.ndim == 0:
        return a.expand(n_queries, 1).contiguous()
    a = a.reshape(-1, 1)
    if a.shape[0] != n_queries:
        raise ValueError(f"alpha length {a.shape[0]} != query count {n_queries}")
    return a.contiguous()


def blended_scores(queries, img_emb, txt_emb, alpha, queries_txt=None) -> torch.Tensor:
    """[Q, N] ``alpha * T2I + (1 - alpha) * T2T`` with f32 accumulation."""
    a = alpha_column(alpha, queries.shape[0], queries.device)
    q_txt = queries if queries_txt is None else queries_txt
    t2i = queries.float() @ img_emb.float().T
    t2t = q_txt.float() @ txt_emb.float().T
    return a * t2i + (1.0 - a) * t2t


def blended_scores_q8(queries, img_q, img_scale, txt_q, txt_scale, alpha, queries_txt=None) -> torch.Tensor:
    """[Q, N] scores over an int8 corpus: raw dot at the query dtype (the
    int8 -> query dtype conversion is exact), then per-row scales on the f32
    score columns."""
    a = alpha_column(alpha, queries.shape[0], queries.device)
    q_txt = queries if queries_txt is None else queries_txt
    t2i = queries.float() @ img_q.to(queries.dtype).float().T
    t2t = q_txt.float() @ txt_q.to(q_txt.dtype).float().T
    img_s = img_scale.float().reshape(1, -1)
    txt_s = txt_scale.float().reshape(1, -1)
    return a * (t2i * img_s) + (1.0 - a) * (t2t * txt_s)


def quantize_corpus_host(emb) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 on the host: ``(q int8 [N, D], scale f32 [N, 1])``
    — the f32 corpus never stages on the device."""
    emb = np.asarray(emb, np.float32)
    scale = np.maximum(np.max(np.abs(emb), axis=1, keepdims=True) / 127.0, 1e-12)
    q = np.round(emb / scale).astype(np.int8)
    return q, scale.astype(np.float32)


def dequantize_corpus(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def prefix_normalize(x: torch.Tensor, dim: int) -> torch.Tensor:
    """First ``dim`` coordinates, re-L2-normalized (f32 norm math): the
    Matryoshka serving primitive. Zero rows stay zero (guarded divide)."""
    if not 0 < dim <= x.shape[-1]:
        raise ValueError(f"truncate dim {dim} not in 1..{x.shape[-1]}")
    t = x[..., :dim].float()
    n = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    return (t / torch.clamp(n, min=1e-12)).to(x.dtype)


def prefix_normalize_host(x, dim: int) -> np.ndarray:
    """NumPy twin of :func:`prefix_normalize` for host-side corpus staging."""
    x = np.asarray(x)
    if not 0 < dim <= x.shape[-1]:
        raise ValueError(f"truncate dim {dim} not in 1..{x.shape[-1]}")
    t = x[..., :dim].astype(np.float32)
    n = np.linalg.norm(t, axis=-1, keepdims=True)
    return t / np.maximum(n, 1e-12)


def random_rotation(dim: int, seed: int = 0) -> np.ndarray:
    """Seeded random orthonormal rotation ``R [dim, dim]`` (f32 NumPy): QR
    of a Gaussian with the R-diagonal sign fix, the JAX package's draw bit
    for bit. Rotating corpus rows and queries by the same R leaves exact
    inner products unchanged but spreads each row's energy across
    coordinates, so int4/int8 grids and sign sketches lose less recall."""
    rng = np.random.default_rng(np.uint64(seed) + 0x5EED)
    g = rng.standard_normal((dim, dim))
    q, r = np.linalg.qr(g)
    return (q * np.sign(np.diag(r))).astype(np.float32)


# int4 corpus, plane layout: packed byte column j holds dim j in the LOW
# nibble and dim j + D/2 in the HIGH nibble (both 4-bit two's complement),
# so q . row == q_lo . lo + q_hi . hi over two contiguous [N, D/2] planes.


def quantize_corpus_host_q4(emb) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int4, nibble-packed: ``(packed int8 [N, D/2],
    scale f32 [N, 1])``, ``emb ~= unpack(packed) * scale``. ``D`` must be
    even. Host-side, so the f32 corpus never stages on the device."""
    emb = np.asarray(emb, np.float32)
    n, d = emb.shape
    if d % 2:
        raise ValueError(f"int4 packing needs an even embedding dim, got {d}")
    scale = np.maximum(np.max(np.abs(emb), axis=1, keepdims=True) / 7.0, 1e-12)
    q = np.clip(np.round(emb / scale), -8, 7).astype(np.int8)
    lo, hi = q[:, : d // 2], q[:, d // 2 :]
    packed = ((hi.astype(np.uint8) << 4) | (lo.astype(np.uint8) & 0xF)).view(np.int8)
    return packed, scale.astype(np.float32)


def _unpack_q4(packed: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """[N, D/2] packed int8 -> (lo, hi) planes in ``dtype`` (exact: 4-bit
    values fit every float mantissa). The high nibble is the arithmetic
    shift of the sign-extended byte; the low one sign-extends 4 bits."""
    b = packed.to(torch.int32)
    hi = b >> 4
    lo = ((b & 0xF) ^ 8) - 8
    return lo.to(dtype), hi.to(dtype)


def dequantize_corpus_q4(packed: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    lo, hi = _unpack_q4(packed, torch.float32)
    return (torch.cat([lo, hi], dim=1) * scale.float()).to(dtype)


def blended_scores_q4(queries, img_p, img_scale, txt_p, txt_scale, alpha, queries_txt=None) -> torch.Tensor:
    """[Q, N] scores over a nibble-packed int4 corpus, op-order-matched to
    the kernel: unpack the planes to the query dtype, one half-width dot per
    plane with f32 accumulation, per-row scales on the f32 score columns."""
    a = alpha_column(alpha, queries.shape[0], queries.device)
    q_txt = queries if queries_txt is None else queries_txt
    d2 = img_p.shape[1]

    def plane_scores(q, packed):
        lo, hi = _unpack_q4(packed, q.dtype)
        return q[:, :d2].float() @ lo.float().T + q[:, d2:].float() @ hi.float().T

    t2i = plane_scores(queries, img_p)
    t2t = plane_scores(q_txt, txt_p)
    img_s = img_scale.float().reshape(1, -1)
    txt_s = txt_scale.float().reshape(1, -1)
    return a * (t2i * img_s) + (1.0 - a) * (t2t * txt_s)


def rerank_scores_host(queries, image, text, idx, alpha) -> Tuple[np.ndarray, np.ndarray]:
    """Exact f32 host rescore of fetched candidates (the JAX package's
    two-tier rerank semantics, in NumPy). ``queries`` [Q, D], ``image`` /
    ``text`` [N, D] f32 host rows, ``idx`` [Q, R] candidate rows (-1 = ann
    sentinel, masked to -inf). Returns ``(scores, idx)`` sorted descending
    with stable ties. ``KEMR_NATIVE_RERANK=1`` opts into the
    native C++ rescore of ``native/rerank.cpp``."""
    import os

    queries = np.asarray(queries, np.float32)
    idx = np.asarray(idx)
    s = None
    if os.environ.get("KEMR_NATIVE_RERANK"):
        from ..native.rerank_wrapper import rerank_scores_native

        s = rerank_scores_native(queries, np.asarray(image), np.asarray(text), idx, alpha)
    if s is None:
        # per-query row gathers + BLAS matvec (the JAX package's loop)
        a = np.broadcast_to(np.asarray(alpha, np.float32).reshape(-1), (queries.shape[0],))
        image = np.asarray(image)
        text = np.asarray(text)
        safe = np.maximum(idx, 0)
        s = np.empty(idx.shape, np.float32)
        for q in range(idx.shape[0]):
            rows = safe[q]
            s[q] = a[q] * (image[rows] @ queries[q]) + (1.0 - a[q]) * (text[rows] @ queries[q])
        s = np.where(idx >= 0, s, -np.inf).astype(np.float32)
    order = np.argsort(-s, axis=1, kind="stable")
    return np.take_along_axis(s, order, 1), np.take_along_axis(idx, order, 1)


def _stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lowest position."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _segmented_topk_from_scores(scores: torch.Tensor, k: int, segment: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact two-stage top-k (per-segment, then a merge) for k > 128."""
    qn, n = scores.shape
    k = min(k, n)
    seg = min(segment, n)
    pad = (-n) % seg
    if pad:
        scores = torch.nn.functional.pad(scores, (0, pad), value=_NEG_INF)
    n_seg = scores.shape[1] // seg
    k_local = min(k, seg)
    v1, i1 = _stable_topk(scores.reshape(qn, n_seg, seg), k_local)
    i1 = i1 + (torch.arange(n_seg, device=scores.device) * seg)[None, :, None]
    v2, pos = _stable_topk(v1.reshape(qn, n_seg * k_local), k)
    idx = torch.take_along_dim(i1.reshape(qn, n_seg * k_local), pos, dim=1)
    return v2, idx.to(torch.int32)


def topk_plain(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's selection over a materialized [Q, N] score matrix."""
    scores = torch.where(torch.isnan(scores), torch.full_like(scores, _NEG_INF), scores)
    vals, idx = _stable_topk(scores, k)
    idx = torch.where(vals > _NEG_INF, idx, torch.zeros_like(idx))
    return vals, idx.to(torch.int32)


def _select(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CPU route's selection: the kernel's up to k = 128, the segmented
    one above it, as the JAX package selects past its kernel's cap."""
    if k > _SEGMENTED_K:
        return _segmented_topk_from_scores(scores, k, segment=4096)
    return topk_plain(scores, k)


def pass_sizes(k: int) -> Tuple[int, int]:
    """``(passes, rows per pass)`` for a kernel asked for ``k`` rows: the
    fewest passes of at most ``KERNEL_PASS_K``, all of one size, so that
    every pass launches the same configuration and recomputes the same
    scores."""
    passes = -(-k // KERNEL_PASS_K)
    return passes, -(-k // passes)


def topk_passes(launch, n_queries: int, k: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k through ``launch(k_pass, ceil_v, ceil_r) -> (values, rows)``, one
    kernel pass per call. A pass after the first is given each query's
    ceiling, the last (value, row) of the pass before, and selects among the
    rows that rank below it (value descending, row ascending), so the passes
    concatenated are the top-k. A pass that ends in a filler (float32 min)
    ends the run: the rest are fillers."""
    passes, kp = pass_sizes(k)
    vals, rows = [], []
    ceil_v = ceil_r = None
    for p in range(passes):
        v, r = launch(kp, ceil_v, ceil_r)
        vals.append(v)
        rows.append(r)
        if p + 1 == passes:
            break
        if not bool((v[:, -1] > _NEG_INF).any()):
            rest = k - (p + 1) * kp
            vals.append(torch.full((n_queries, rest), _NEG_INF, dtype=torch.float32, device=device))
            rows.append(torch.zeros((n_queries, rest), dtype=torch.int32, device=device))
            break
        ceil_v, ceil_r = v[:, -1].contiguous(), r[:, -1].contiguous()
    return torch.cat(vals, 1)[:, :k], torch.cat(rows, 1)[:, :k]


def topk_passes_plain(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' passes in plain PyTorch: each pass masks the rows at or
    above the ceiling to float32 min and takes the plain top-k of what is
    left. Equals :func:`topk_plain` at every k."""
    scores = torch.where(torch.isnan(scores), torch.full_like(scores, _NEG_INF), scores)
    cols = torch.arange(scores.shape[1], device=scores.device)[None, :]

    def launch(kp, ceil_v, ceil_r):
        s = scores
        if ceil_v is not None:
            cv, cr = ceil_v[:, None], ceil_r[:, None]
            s = torch.where((s > cv) | ((s == cv) & (cols <= cr)), torch.full_like(s, _NEG_INF), s)
        return topk_plain(s, kp)

    return topk_passes(launch, scores.shape[0], k, scores.device)


_TOPK_ARGS = [I, I] + [P] * 9 + [I] * 5 + [P] * 6 + [P]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def _query_block(q_code: int, qn: int, k: int) -> int:
    """Queries one block of the kernel takes (the kernel's own rule)."""
    return dispatch.kernel("kemr_topk_query_block", [I, I, I])(q_code, qn, k)


def scan_strips(n_rows: int, query_blocks: int, blocks_wanted: int, tile: int = _TILE) -> int:
    """Strips the kernel cuts the corpus into: each block walks one strip of
    ``tile``-row tiles for one block of queries and carries the running
    top-k, so the grid is ``(strips, query blocks)`` and about
    ``blocks_wanted`` in all (the device's SM count on the tensor-core route
    and for B5); never more strips than tiles."""
    n_tiles = -(-n_rows // tile)
    return max(1, min(n_tiles, blocks_wanted // max(1, query_blocks)))


def scan_scratch(n_queries: int, query_block: int, n_strips: int, k: int, device):
    """The scan's scratch: the candidate lists ``[Q rounded up to the query
    block, strips, k]`` (f32 values, i32 rows; a block above k = 128 keeps its
    running lists there) and, above k = 128, the pairwise merge's second
    buffer ``[Q, ceil(strips / 2), k]`` (else empty)."""
    qp = -(-n_queries // query_block) * query_block
    merge = (n_queries, -(-n_strips // 2), k) if k > _SMEM_LIST_K else (0,)
    return (torch.empty((qp, n_strips, k), dtype=torch.float32, device=device),
            torch.empty((qp, n_strips, k), dtype=torch.int32, device=device),
            torch.empty(merge, dtype=torch.float32, device=device),
            torch.empty(merge, dtype=torch.int32, device=device))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None or t.numel() == 0 else t.data_ptr()


@dispatch.counted
def similarity_topk_kernel(
    queries_img, queries_txt, img, txt, img_scale, txt_scale, alpha_col, k: int, q4: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B2 on CUDA tensors (exact mode when the scales are None; with
    ``q4`` the int8 corpus holds nibble-packed rows of ``D / 2`` bytes): one
    launch a pass, ``pass_sizes(k)[0]`` passes."""
    dev = queries_img.device
    qn, d = queries_img.shape
    n = img.shape[0]
    qdt, cdt = queries_img.dtype, img.dtype
    if qdt not in (torch.float32, torch.bfloat16) or cdt not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtypes: queries {qdt}, corpus {cdt}")
    if (img_scale is None) != (cdt != torch.int8):
        raise ValueError("per-row scales go with an int8 corpus, and only with one")
    if q4 and (cdt != torch.int8 or d % 2):
        raise ValueError(f"q4 mode needs an int8 packed corpus and an even query width, got {cdt}, {d}")
    if cdt != torch.int8 and cdt != qdt:
        raise ValueError(f"exact mode needs queries in the corpus dtype ({cdt}), got {qdt}")
    if not 0 < k <= n:
        raise ValueError(f"kernel k must be in 1..{n} (the corpus rows), got {k}")
    dispatch.require(queries_img, "queries_img", qdt, dev, (qn, d))
    dispatch.require(queries_txt, "queries_txt", qdt, dev, (qn, d))
    dc = d // 2 if q4 else d
    dispatch.require(img, "img", cdt, dev, (n, dc))
    dispatch.require(txt, "txt", cdt, dev, (n, dc))
    dispatch.require(alpha_col, "alpha", torch.float32, dev, (qn, 1))
    if img_scale is not None:
        dispatch.require(img_scale, "img_scale", torch.float32, dev, (n, 1))
        dispatch.require(txt_scale, "txt_scale", torch.float32, dev, (n, 1))
    kp = pass_sizes(k)[1]
    lists = 2 * kp if kp <= _SMEM_LIST_K else 0
    if qdt == torch.float32 and (_F32_QUERY_GROUP * (d + lists + 2 * _TILE)) * 4 > 227 * 1024:
        raise ValueError(f"embedding width {d} exceeds the kernel's shared-memory budget")
    codes = (_DTYPE_CODE[qdt], _Q4_CODE if q4 else _DTYPE_CODE[cdt])
    per_block = _query_block(codes[0], qn, kp)
    wanted = _sm_count(dev) * (_F32_BLOCKS_PER_SM if qdt == torch.float32 else 1)
    n_strips = scan_strips(n, -(-qn // per_block), wanted)
    fn = dispatch.kernel("kemr_similarity_topk", _TOPK_ARGS)

    def launch(kp, ceil_v, ceil_r):
        scratch = scan_scratch(qn, per_block, n_strips, kp, dev)
        vals = torch.empty((qn, kp), dtype=torch.float32, device=dev)
        idx = torch.empty((qn, kp), dtype=torch.int32, device=dev)
        status = fn(
            *codes, queries_img.data_ptr(), queries_txt.data_ptr(), img.data_ptr(), txt.data_ptr(),
            _ptr(img_scale), _ptr(txt_scale), alpha_col.data_ptr(), _ptr(ceil_v), _ptr(ceil_r),
            qn, n, d, kp, n_strips, *map(_ptr, scratch),
            vals.data_ptr(), idx.data_ptr(), dispatch.stream_of(queries_img),
        )
        dispatch.check(status, "similarity_topk_kernel")
        dispatch.count_launch(similarity_topk_kernel)
        return vals, idx

    return topk_passes(launch, qn, k, dev)


def fused_similarity_topk(
    queries_img: torch.Tensor,
    img_emb: torch.Tensor,
    txt_emb: torch.Tensor,
    k: int,
    alpha=0.5,
    queries_txt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend + top-k over an exact corpus: ``(values [Q, k] f32, rows [Q, k] i32)``."""
    qn = queries_img.shape[0]
    q_txt = queries_img if queries_txt is None else queries_txt
    k = min(k, img_emb.shape[0])
    if not dispatch.use_kernel(queries_img):
        return _select(blended_scores(queries_img, img_emb, txt_emb, alpha, queries_txt), k)
    a = alpha_column(alpha, qn, queries_img.device)
    return similarity_topk_kernel(queries_img, q_txt, img_emb, txt_emb, None, None, a, k)


def fused_similarity_topk_q8(
    queries_img: torch.Tensor,
    img_q: torch.Tensor,
    img_scale: torch.Tensor,
    txt_q: torch.Tensor,
    txt_scale: torch.Tensor,
    k: int,
    alpha=0.5,
    queries_txt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend + top-k over an int8 corpus (:func:`quantize_corpus_host`)."""
    qn = queries_img.shape[0]
    q_txt = queries_img if queries_txt is None else queries_txt
    k = min(k, img_q.shape[0])
    if not dispatch.use_kernel(queries_img):
        return _select(blended_scores_q8(queries_img, img_q, img_scale, txt_q, txt_scale, alpha, queries_txt), k)
    a = alpha_column(alpha, qn, queries_img.device)
    return similarity_topk_kernel(
        queries_img, q_txt, img_q, txt_q, img_scale.reshape(-1, 1), txt_scale.reshape(-1, 1), a, k
    )


def fused_similarity_topk_q4(
    queries_img: torch.Tensor,
    img_p: torch.Tensor,
    img_scale: torch.Tensor,
    txt_p: torch.Tensor,
    txt_scale: torch.Tensor,
    k: int,
    alpha=0.5,
    queries_txt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend + top-k over a nibble-packed int4 corpus
    (:func:`quantize_corpus_host_q4`): B2's q4 mode on CUDA tensors."""
    qn = queries_img.shape[0]
    q_txt = queries_img if queries_txt is None else queries_txt
    k = min(k, img_p.shape[0])
    if not dispatch.use_kernel(queries_img):
        return _select(blended_scores_q4(queries_img, img_p, img_scale, txt_p, txt_scale, alpha, queries_txt), k)
    a = alpha_column(alpha, qn, queries_img.device)
    return similarity_topk_kernel(
        queries_img, q_txt, img_p, txt_p, img_scale.reshape(-1, 1), txt_scale.reshape(-1, 1), a, k, q4=True
    )


# -- masked (filtered) search -------------------------------------------------
# A bool row mask, [N] (one filter for the batch) or [Q, N] (one per query),
# restricts the scan to eligible rows: the JAX package's masked search, which
# runs no Pallas kernel there either. The blended scores are materialized
# (a [256, 43,000] f32 matrix is 44 MB), ineligible rows score float32 min,
# and the selection is the segmented exact top-k. Slots past the eligible
# rows come back with the -1 row sentinel, as the IVF path returns them.


def normalize_mask(mask, n_queries: int, n_rows: int, device=None) -> torch.Tensor:
    """A row filter as a bool ``[1 or Q, N]`` tensor (True = row eligible)."""
    m = torch.as_tensor(np.asarray(mask) if not torch.is_tensor(mask) else mask, device=device)
    if m.ndim == 1:
        m = m[None, :]
    if m.ndim != 2 or m.shape[-1] != n_rows or m.shape[0] not in (1, n_queries):
        raise ValueError(f"mask shape {tuple(m.shape)} incompatible with {n_queries} queries x {n_rows} rows")
    return m.bool()


def _masked_topk_from_scores(scores: torch.Tensor, mask, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    m = normalize_mask(mask, scores.shape[0], scores.shape[1], device=scores.device)
    scores = torch.where(m, scores, torch.full_like(scores, _NEG_INF))
    vals, idx = _segmented_topk_from_scores(scores, k, segment=4096)
    # fewer than k eligible rows: sentinel the dead slots
    return vals, torch.where(vals > _NEG_INF / 2, idx, torch.full_like(idx, -1))


def masked_similarity_topk(queries, img_emb, txt_emb, mask, k: int, alpha=0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact blended top-k restricted to ``mask``-eligible corpus rows."""
    return _masked_topk_from_scores(blended_scores(queries, img_emb, txt_emb, alpha), mask, k)


def masked_similarity_topk_q8(queries, img_q, img_scale, txt_q, txt_scale, mask, k: int,
                              alpha=0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over an int8 corpus (the q8 scan's rounding)."""
    return _masked_topk_from_scores(blended_scores_q8(queries, img_q, img_scale, txt_q, txt_scale, alpha), mask, k)


def masked_similarity_topk_q4(queries, img_p, img_scale, txt_p, txt_scale, mask, k: int,
                              alpha=0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over a nibble-packed int4 corpus."""
    return _masked_topk_from_scores(blended_scores_q4(queries, img_p, img_scale, txt_p, txt_scale, alpha), mask, k)


# -- mesh-sharded corpus ------------------------------------------------------
# The corpus rows shard over one mesh axis (``parallel.sharding.shard_rows``):
# each shard is scanned on its own device by the one-device route (B2 in the
# matching mode on a CUDA shard, the plain version on a CPU one) at
# k_local = min(k, shard_n), its rows offset to global ones, and only the
# [Q, k_local] winners move: to the mesh's first device, and across processes
# through ``torch.distributed``. The merge flattens them shard-major and takes
# the stable top-k, so ties keep the lowest global row, as JAX's
# ``lax.top_k`` over the gathered winners does.


def _merge_shard_winners(all_vals: torch.Tensor, all_idx: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[S, Q, k_local]`` winners with global rows -> the final ``[Q, k]``:
    flattened shard-major, then the top-k with ties to the first position."""
    s, qn, kl = all_vals.shape
    flat_v = all_vals.permute(1, 0, 2).reshape(qn, s * kl)
    flat_i = all_idx.permute(1, 0, 2).reshape(qn, s * kl)
    vals, pos = _stable_topk(flat_v, k)
    return vals, torch.gather(flat_i, 1, pos).to(torch.int32)


def sharded_scan(mesh, axis: str, corpus: Sequence, scan) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Run ``scan(device, shard_index, shard_n, *corpus shards) -> (values,
    local rows)`` on each of this process's shards of ``corpus`` (tensors or
    ``RowShards``, all sharded alike); returns every shard's winners
    ``[S, Q, k_local]`` with global rows on the mesh's first device, the
    shard count and the rows a shard holds."""
    from ..parallel.sharding import gather_shard_outputs, shard_rows

    parts = [shard_rows(c, mesh, axis) for c in corpus]
    shard_n, n_shards = parts[0].shard_n, parts[0].n_shards
    vals, rows = [], []
    for j, (g, t) in enumerate(parts[0].shards):
        v, i = scan(t.device, g, shard_n, *(p.shards[j][1] for p in parts))
        vals.append(v.float())
        rows.append(i.to(torch.int32) + g * shard_n)
    return gather_shard_outputs(vals, mesh), gather_shard_outputs(rows, mesh), n_shards, shard_n


def _sharded_topk(fn, queries, corpus, k: int, alpha, mesh, axis: str):
    n = corpus[0].shape[0]
    k = min(k, n)
    a = alpha_column(alpha, queries.shape[0], queries.device)

    def scan(dev, g, shard_n, *shards):
        return fn(queries.to(dev), *shards, k=min(k, shard_n), alpha=a.to(dev))

    all_v, all_i, _, _ = sharded_scan(mesh, axis, corpus, scan)
    return _merge_shard_winners(all_v, all_i, k)


def sharded_similarity_topk(queries, img_emb, txt_emb, k: int, alpha, mesh, axis: str = "data"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over an exact corpus row-sharded on ``axis``: each shard's B2
    scan (plain version on the CPU), then the merge of the winners."""
    def one(q, img, txt, *, k, alpha):
        return fused_similarity_topk(q, img, txt, k=k, alpha=alpha)

    return _sharded_topk(one, queries, (img_emb, txt_emb), k, alpha, mesh, axis)


def sharded_similarity_topk_q8(queries, img_q, img_scale, txt_q, txt_scale, k: int, alpha, mesh,
                               axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sharded_similarity_topk` over an int8 corpus: each device holds
    only its int8 shard and per-row scales."""
    def one(q, img, img_s, txt, txt_s, *, k, alpha):
        return fused_similarity_topk_q8(q, img, img_s, txt, txt_s, k=k, alpha=alpha)

    return _sharded_topk(one, queries, (img_q, img_scale, txt_q, txt_scale), k, alpha, mesh, axis)


def sharded_similarity_topk_q4(queries, img_p, img_scale, txt_p, txt_scale, k: int, alpha, mesh,
                               axis: str = "data") -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sharded_similarity_topk` over a nibble-packed int4 corpus (B2-q4 a shard)."""
    def one(q, img, img_s, txt, txt_s, *, k, alpha):
        return fused_similarity_topk_q4(q, img, img_s, txt, txt_s, k=k, alpha=alpha)

    return _sharded_topk(one, queries, (img_p, img_scale, txt_p, txt_scale), k, alpha, mesh, axis)


def sharded_masked_topk(score_fn, queries, corpus: Sequence, mask, k: int, alpha, mesh, axis: str = "data"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over a row-sharded corpus: ``score_fn(q, *shards,
    alpha) -> [Q, shard_n]`` scores a shard, the mask's columns shard with
    the rows, the local selection is the segmented exact top-k, and dead
    slots carry the ``-1`` row sentinel after the merge."""
    n = corpus[0].shape[0]
    k = min(k, n)
    a = alpha_column(alpha, queries.shape[0], queries.device)
    m2d = normalize_mask(mask, queries.shape[0], n, device=queries.device)

    def scan(dev, g, shard_n, *shards):
        m = m2d[:, g * shard_n:(g + 1) * shard_n].to(dev)
        scores = score_fn(queries.to(dev), *shards, a.to(dev))
        scores = torch.where(m, scores, torch.full_like(scores, _NEG_INF))
        return _segmented_topk_from_scores(scores, min(k, shard_n), segment=4096)

    all_v, all_i, _, _ = sharded_scan(mesh, axis, corpus, scan)
    vals, idx = _merge_shard_winners(all_v, all_i, k)
    return vals, torch.where(vals > _NEG_INF / 2, idx, torch.full_like(idx, -1))


def sharded_masked_similarity_topk(queries, corpus_args: Sequence, mask, k: int, alpha, mesh,
                                   axis: str = "data", mode: str = "exact") -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked top-k over a row-sharded corpus. ``corpus_args``: ``(img,
    txt)`` exact or ``(img, img_scale, txt, txt_scale)`` for ``mode`` in
    {"q8", "q4"}."""
    score_fn = {"exact": blended_scores, "q8": blended_scores_q8, "q4": blended_scores_q4}[mode]
    return sharded_masked_topk(score_fn, queries, corpus_args, mask, k, alpha, mesh, axis)
