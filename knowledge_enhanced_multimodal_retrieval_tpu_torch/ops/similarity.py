"""Blended two-tower similarity + top-k: the retrieval scan.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/ops/similarity.py``
for the exact and int8 corpus modes:

    scores = alpha * (Q @ IMG^T) + (1 - alpha) * (Q @ TXT^T);  top-k(scores)

:func:`fused_similarity_topk` / :func:`fused_similarity_topk_q8` launch the
kernel B2 (``csrc/similarity.cu``) on CUDA tensors and run the plain
version on CPU tensors. Selection semantics are the TPU kernel's: pad and
NaN scores become float32 min, ties go to the lowest corpus row, and a
query with fewer than k finite scores is filled with (float32 min, row 0).
k > 128 takes the segmented exact selection over plain scores, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import dispatch
from .dispatch import I, P

_NEG_INF = float(np.finfo(np.float32).min)
_MAX_KERNEL_K = 128  # per-tile candidate lists hold at most the 128-row tile
_TILE = 128  # corpus rows per kernel tile (csrc/similarity.cu TK_T)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def alpha_column(alpha, n_queries: int, device) -> torch.Tensor:
    """A scalar or per-query blend weight as an f32 ``[Q, 1]`` column."""
    a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
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


_TOPK_ARGS = [I, I] + [P] * 7 + [I] * 4 + [P] * 4 + [P]


@dispatch.counted
def similarity_topk_kernel(
    queries_img, queries_txt, img, txt, img_scale, txt_scale, alpha_col, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B2 on CUDA tensors (exact mode when the scales are None)."""
    dev = queries_img.device
    qn, d = queries_img.shape
    n = img.shape[0]
    qdt, cdt = queries_img.dtype, img.dtype
    if qdt not in (torch.float32, torch.bfloat16) or cdt not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtypes: queries {qdt}, corpus {cdt}")
    if (img_scale is None) != (cdt != torch.int8):
        raise ValueError("per-row scales go with an int8 corpus, and only with one")
    if cdt != torch.int8 and cdt != qdt:
        raise ValueError(f"exact mode needs queries in the corpus dtype ({cdt}), got {qdt}")
    if not 0 < k <= _MAX_KERNEL_K:
        raise ValueError(f"kernel k must be in 1..{_MAX_KERNEL_K}, got {k}")
    dispatch.require(queries_img, "queries_img", qdt, dev, (qn, d))
    dispatch.require(queries_txt, "queries_txt", qdt, dev, (qn, d))
    dispatch.require(img, "img", cdt, dev, (n, d))
    dispatch.require(txt, "txt", cdt, dev, (n, d))
    dispatch.require(alpha_col, "alpha", torch.float32, dev, (qn, 1))
    if img_scale is not None:
        dispatch.require(img_scale, "img_scale", torch.float32, dev, (n, 1))
        dispatch.require(txt_scale, "txt_scale", torch.float32, dev, (n, 1))
    if (16 * d + 2 * 16 * _TILE) * 4 > 227 * 1024:
        raise ValueError(f"embedding width {d} exceeds the kernel's shared-memory budget")
    n_tiles = -(-n // _TILE)
    cand_v = torch.empty((qn, n_tiles, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((qn, n_tiles, k), dtype=torch.int32, device=dev)
    vals = torch.empty((qn, k), dtype=torch.float32, device=dev)
    idx = torch.empty((qn, k), dtype=torch.int32, device=dev)
    fn = dispatch.kernel("kemr_similarity_topk", _TOPK_ARGS)
    status = fn(
        _DTYPE_CODE[qdt], _DTYPE_CODE[cdt], queries_img.data_ptr(), queries_txt.data_ptr(),
        img.data_ptr(), txt.data_ptr(),
        None if img_scale is None else img_scale.data_ptr(),
        None if txt_scale is None else txt_scale.data_ptr(),
        alpha_col.data_ptr(), qn, n, d, k, cand_v.data_ptr(), cand_i.data_ptr(),
        vals.data_ptr(), idx.data_ptr(), dispatch.stream_of(queries_img),
    )
    dispatch.check(status, "similarity_topk_kernel")
    similarity_topk_kernel.launches += 1
    return vals, idx


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
    if k > _MAX_KERNEL_K:
        scores = blended_scores(queries_img, img_emb, txt_emb, alpha, queries_txt)
        return _segmented_topk_from_scores(scores, k, segment=4096)
    if not dispatch.use_kernel(queries_img):
        return topk_plain(blended_scores(queries_img, img_emb, txt_emb, alpha, queries_txt), k)
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
    if k > _MAX_KERNEL_K:
        scores = blended_scores_q8(queries_img, img_q, img_scale, txt_q, txt_scale, alpha, queries_txt)
        return _segmented_topk_from_scores(scores, k, segment=4096)
    if not dispatch.use_kernel(queries_img):
        scores = blended_scores_q8(queries_img, img_q, img_scale, txt_q, txt_scale, alpha, queries_txt)
        return topk_plain(scores, k)
    a = alpha_column(alpha, qn, queries_img.device)
    return similarity_topk_kernel(
        queries_img, q_txt, img_q, txt_q, img_scale.reshape(-1, 1), txt_scale.reshape(-1, 1), a, k
    )
