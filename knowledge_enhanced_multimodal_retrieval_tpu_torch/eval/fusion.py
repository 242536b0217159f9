"""Score-level fusion of CLIP similarity with Text2SPARQL KG hits.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/eval/fusion.py``.
UUID/URI bookkeeping happens once on the host and yields a hit structure;
the numeric combine is a tensor expression on the scores' device.

Strategies (the reference's formulas and defaults):

- weighted: ``alpha * S + w_sparql * I[hit]``, the weights renormalized when
  they do not sum to 1;
- additive: ``S + delta * I[hit]``;
- adaptive: ``S + delta * omega(|R(q)|) * I[hit]``, with the result-set-size
  decay omega over thresholds {1: 1.0, 5: 0.8, 20: 0.5, 50: 0.3, inf: 0.1}.

URIs map to UUIDs by their last path segment. The sweep's scale-safe form,
:func:`weighted_fusion_ranks_blocked`, ranks query stripes with the sparse
hit bonus scatter-added per stripe and never holds the [N, N] matrix.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .metrics import as_f32, compute_mrr_and_mean_rank, compute_recall_at_k

DEFAULT_SIZE_THRESHOLDS: Tuple[Tuple[float, float], ...] = (
    (1, 1.0),
    (5, 0.8),
    (20, 0.5),
    (50, 0.3),
    (float("inf"), 0.1),
)


def uri_to_uuid(uri: str) -> str:
    """Last path segment of a URI, or the string itself."""
    return uri.split("/")[-1] if "/" in uri else uri


def build_hit_matrix(
    text2sparql_results: Mapping[str, Sequence[str]],
    query_uuids: Sequence[str],
    artefact_uuids: Sequence[str],
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: binary hit matrix [Q, N] + per-query SPARQL result-set size
    (counting every returned URI, also those outside the corpus)."""
    artefact_to_idx = {u: i for i, u in enumerate(artefact_uuids)}
    hits = np.zeros((len(query_uuids), len(artefact_uuids)), np.float32)
    sizes = np.zeros((len(query_uuids),), np.int32)
    for qi, quuid in enumerate(query_uuids):
        uris = text2sparql_results.get(quuid, [])
        sizes[qi] = len(uris)
        for uri in uris:
            idx = artefact_to_idx.get(uri_to_uuid(uri))
            if idx is not None:
                hits[qi, idx] = 1.0
    return hits, sizes


def build_hit_indices(
    text2sparql_results: Mapping[str, Sequence[str]],
    query_uuids: Sequence[str],
    artefact_uuids: Sequence[str],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse hits: ``(idx [Q, H] int32, mask [Q, H] f32, sizes [Q] int32)``,
    H the largest hit count (at least 1). Indices are deduplicated so the
    scatter-add applies each bonus once; padding is index 0 with mask 0."""
    artefact_to_idx = {u: i for i, u in enumerate(artefact_uuids)}
    per_q = []
    sizes = np.zeros((len(query_uuids),), np.int32)
    for qi, quuid in enumerate(query_uuids):
        uris = text2sparql_results.get(quuid, [])
        sizes[qi] = len(uris)
        hit = {artefact_to_idx[u] for u in map(uri_to_uuid, uris) if u in artefact_to_idx}
        per_q.append(sorted(hit))
    h = max((len(x) for x in per_q), default=0) or 1
    idx = np.zeros((len(per_q), h), np.int32)
    mask = np.zeros((len(per_q), h), np.float32)
    for qi, xs in enumerate(per_q):
        idx[qi, : len(xs)] = xs
        mask[qi, : len(xs)] = 1.0
    return idx, mask, sizes


def _weighted_fusion_stripe_ranks(qb, tgt, img, hit_idx_b, hit_mask_b, start: int,
                                  w_t2i: float, w_t2t: float, alpha: float, sparql_weight: float) -> torch.Tensor:
    """Diagonal ranks of one stripe of
    ``alpha * (w_t2i * Q@I^T + w_t2t * Q@T^T) + sparql_weight * I[hit]``,
    in the reference's operation order."""
    sim = w_t2i * (qb @ img.T)
    sim = sim + w_t2t * (qb @ tgt.T)
    sim = alpha * sim
    rows = torch.arange(qb.shape[0], device=qb.device)
    sim.index_put_((rows[:, None].expand_as(hit_idx_b), hit_idx_b), sparql_weight * hit_mask_b, accumulate=True)
    cols = torch.clamp(start + rows, 0, sim.shape[1] - 1)
    diag = sim[rows, cols]
    return 1 + torch.sum(sim > diag[:, None], dim=1, dtype=torch.int32)


def weighted_fusion_ranks_blocked(
    query_emb,
    target_emb,
    image_emb,
    hit_idx: np.ndarray,
    hit_mask: np.ndarray,
    t2i_weight: float,
    t2t_weight: float,
    alpha: float,
    sparql_weight: float,
    block: int = 1024,
) -> torch.Tensor:
    """Diagonal ranks of the weighted CLIP x SPARQL fusion, blockwise, on
    the embeddings' device (peak memory O(block * N))."""
    q, t, i = as_f32(query_emb), as_f32(target_emb), as_f32(image_emb)
    dev = q.device
    hit_idx = torch.as_tensor(np.asarray(hit_idx), dtype=torch.long, device=dev)
    hit_mask = as_f32(hit_mask, dev)
    out = []
    for s in range(0, q.shape[0], block):
        e = s + block
        out.append(_weighted_fusion_stripe_ranks(
            q[s:e], t, i, hit_idx[s:e], hit_mask[s:e], s, t2i_weight, t2t_weight, alpha, sparql_weight))
    return torch.cat(out)


def _omega(sizes: torch.Tensor, thresholds: Tuple[Tuple[float, float], ...]) -> torch.Tensor:
    """Result-set-size decay: the smallest threshold >= size wins; 0 for empty."""
    omega = torch.zeros(sizes.shape, dtype=torch.float32, device=sizes.device)
    for threshold, weight in sorted(thresholds, reverse=True):
        omega = torch.where(sizes <= threshold, torch.full_like(omega, weight), omega)
    return torch.where(sizes == 0, torch.zeros_like(omega), omega)


def weighted_fusion(
    clip_similarity_matrix,
    text2sparql_results: Mapping[str, Sequence[str]],
    query_uuids: Sequence[str],
    artefact_uuids: Sequence[str],
    alpha: float = 0.7,
    sparql_weight: float = 0.3,
) -> torch.Tensor:
    """``alpha * S + w * I[hit]`` with renormalization."""
    sim = as_f32(clip_similarity_matrix)
    _check_shapes(sim, query_uuids, artefact_uuids)
    total = alpha + sparql_weight
    if not np.isclose(total, 1.0):
        alpha, sparql_weight = alpha / total, sparql_weight / total
    hits, _ = build_hit_matrix(text2sparql_results, query_uuids, artefact_uuids)
    return alpha * sim + sparql_weight * as_f32(hits, sim.device)


def additive_bonus_fusion(
    clip_similarity_matrix,
    text2sparql_results: Mapping[str, Sequence[str]],
    query_uuids: Sequence[str],
    artefact_uuids: Sequence[str],
    delta: float = 0.5,
) -> torch.Tensor:
    """``S + delta * I[hit]``."""
    sim = as_f32(clip_similarity_matrix)
    _check_shapes(sim, query_uuids, artefact_uuids)
    hits, _ = build_hit_matrix(text2sparql_results, query_uuids, artefact_uuids)
    return sim + delta * as_f32(hits, sim.device)


def adaptive_additive_fusion(
    clip_similarity_matrix,
    text2sparql_results: Mapping[str, Sequence[str]],
    query_uuids: Sequence[str],
    artefact_uuids: Sequence[str],
    delta: float = 0.5,
    size_thresholds: Optional[Mapping[float, float]] = None,
) -> torch.Tensor:
    """``S + delta * omega(|R(q)|) * I[hit]``."""
    sim = as_f32(clip_similarity_matrix)
    _check_shapes(sim, query_uuids, artefact_uuids)
    thresholds = (
        tuple(sorted(size_thresholds.items())) if size_thresholds is not None else DEFAULT_SIZE_THRESHOLDS
    )
    hits, sizes = build_hit_matrix(text2sparql_results, query_uuids, artefact_uuids)
    omega = _omega(torch.as_tensor(sizes, device=sim.device), thresholds)
    return sim + delta * omega[:, None] * as_f32(hits, sim.device)


def fuse_clip_and_text2sparql(
    clip_similarity_matrix,
    text2sparql_results: Mapping[str, Sequence[str]],
    query_uuids: Sequence[str],
    artefact_uuids: Sequence[str],
    fusion_strategy: str = "weighted",
    fusion_params: Optional[Dict] = None,
) -> torch.Tensor:
    """Strategy dispatcher."""
    p = fusion_params or {}
    args = (clip_similarity_matrix, text2sparql_results, query_uuids, artefact_uuids)
    if fusion_strategy == "weighted":
        return weighted_fusion(*args, alpha=p.get("alpha", 0.7), sparql_weight=p.get("sparql_weight", 0.3))
    if fusion_strategy == "additive":
        return additive_bonus_fusion(*args, delta=p.get("delta", 0.5))
    if fusion_strategy == "adaptive":
        return adaptive_additive_fusion(*args, delta=p.get("delta", 0.5), size_thresholds=p.get("size_thresholds"))
    raise ValueError(f"Unknown fusion strategy: {fusion_strategy}")


def evaluate_retrieval(similarity_matrix) -> Dict[str, float]:
    """Recall@K, MRR and Mean Rank of a fused matrix."""
    metrics: Dict[str, float] = {}
    metrics.update(compute_recall_at_k(similarity_matrix))
    metrics.update(compute_mrr_and_mean_rank(similarity_matrix))
    return metrics


def _check_shapes(sim, query_uuids, artefact_uuids) -> None:
    if sim.shape[0] != len(query_uuids):
        raise ValueError(f"similarity rows ({sim.shape[0]}) != query_uuids ({len(query_uuids)})")
    if sim.shape[1] != len(artefact_uuids):
        raise ValueError(f"similarity cols ({sim.shape[1]}) != artefact_uuids ({len(artefact_uuids)})")
