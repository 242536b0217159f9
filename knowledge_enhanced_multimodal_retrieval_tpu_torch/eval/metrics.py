"""Retrieval metrics — Recall@K, MRR, Mean Rank — on the embeddings' device.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/eval/metrics.py``:
percent-scaled Recall@K and MRR, raw Mean Rank, diagonal ground truth, the
``T2I`` / ``I2T`` / ``T2T`` key prefixes (``T2I_R@1``, ``T2I_MRR``,
``T2I_Mean_Rank``, ...), the weighted T2I+T2T "final" variant, the
fused-matrix variant and the MRR-only path used for early stopping.

The rank of the diagonal entry is ``1 + #{j : s_ij > s_ii}``: one comparison
per row, no sort. Above ``_BLOCK_THRESHOLD`` similarity elements the rows are
ranked in stripes of ``_RANK_BLOCK`` queries, and each stripe reads its
diagonal from its own product, so the stripe and the dense matrix compare
the same accumulations. The products are plain ``torch.matmul`` in f32 (no
TF32: ``cli.evaluate`` pins it off). NumPy inputs go to ``device`` (the CPU
when none is given); tensors stay where they are.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

DEFAULT_KS = (1, 5, 10, 20)
DEFAULT_TASKS = ("T2I", "I2T", "T2T")

# Above this many similarity elements, rank in query stripes instead of
# materializing [N, M] at once (43k x 43k f32 = 7.4 GB).
_BLOCK_THRESHOLD = 64 * 1024 * 1024
_RANK_BLOCK = 1024


def as_f32(x, device=None) -> torch.Tensor:
    """An f32 tensor: NumPy arrays go to ``device`` (CPU by default), a
    tensor stays on its device unless ``device`` is given."""
    if torch.is_tensor(x):
        return x.to(device=device or x.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device or "cpu")


# ---------------------------------------------------------------------------
# Core rank computation
# ---------------------------------------------------------------------------


def diagonal_ranks(similarity) -> torch.Tensor:
    """1-based rank of the diagonal entry within each row, [N] int32."""
    s = as_f32(similarity)
    diag = torch.diagonal(s)[:, None]
    return 1 + torch.sum(s > diag, dim=1, dtype=torch.int32)


def _rank_metrics(ranks: torch.Tensor, ks: Sequence[int], recall: bool, mrr: bool) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    if recall:
        for k in ks:
            out[f"R@{k}"] = torch.mean((ranks <= k).float()) * 100.0
    if mrr:
        out["MRR"] = torch.mean(1.0 / ranks.float()) * 100.0
        out["Mean_Rank"] = torch.mean(ranks.float())
    return out


# ---------------------------------------------------------------------------
# Public API (the reference's signatures)
# ---------------------------------------------------------------------------


def compute_recall_at_k(similarity, k_values: Sequence[int] = DEFAULT_KS) -> Dict[str, float]:
    """Recall@K percentages for an [N, M] similarity matrix."""
    return _to_float(_rank_metrics(diagonal_ranks(similarity), k_values, recall=True, mrr=False))


def compute_mrr_and_mean_rank(similarity) -> Dict[str, float]:
    """MRR (%) and Mean Rank."""
    return _to_float(_rank_metrics(diagonal_ranks(similarity), (), recall=False, mrr=True))


def metrics_from_ranks(
    ranks,
    k_values: Sequence[int] = DEFAULT_KS,
    compute_recall: bool = True,
    compute_mrr: bool = True,
) -> Dict[str, float]:
    """Full metric dict (R@K / MRR / Mean_Rank) from precomputed 1-based ranks."""
    r = ranks if torch.is_tensor(ranks) else torch.as_tensor(np.asarray(ranks))
    return _to_float(_rank_metrics(r, tuple(k_values), compute_recall, compute_mrr))


def _stripe_ranks(sim: torch.Tensor, start: int) -> torch.Tensor:
    """Ranks of the diagonal of one query stripe, read from the stripe itself."""
    rows = torch.arange(sim.shape[0], device=sim.device)
    cols = torch.clamp(start + rows, 0, sim.shape[1] - 1)
    diag = sim[rows, cols]
    return 1 + torch.sum(sim > diag[:, None], dim=1, dtype=torch.int32)


def diagonal_ranks_blocked(q, c, block: int = _RANK_BLOCK) -> torch.Tensor:
    """Diagonal ranks of ``q @ c.T`` without materializing it: peak memory
    O(block * M)."""
    q, c = as_f32(q), as_f32(c)
    ct = c.T
    return torch.cat([_stripe_ranks(q[s : s + block] @ ct, s) for s in range(0, q.shape[0], block)])


def blended_diagonal_ranks_blocked(q, t, i, t2i_weight: float, t2t_weight: float,
                                   block: Optional[int] = None) -> torch.Tensor:
    """Ranks of the diagonal of ``w_t2i * Q@I^T + w_t2t * Q@T^T``, blockwise."""
    block = block or _RANK_BLOCK
    q, t, i = as_f32(q), as_f32(t), as_f32(i)
    out = []
    for s in range(0, q.shape[0], block):
        qb = q[s : s + block]
        sim = t2i_weight * (qb @ i.T)
        sim = sim + t2t_weight * (qb @ t.T)
        out.append(_stripe_ranks(sim, s))
    return torch.cat(out)


def compute_retrieval_metrics(
    query_embeddings,
    candidate_embeddings,
    prefix: str = "",
    k_values: Sequence[int] = DEFAULT_KS,
    compute_recall: bool = True,
    compute_mrr: bool = True,
) -> Dict[str, float]:
    """Metrics from normalized embeddings: sim = Q @ C^T; blockwise above
    ``_BLOCK_THRESHOLD`` elements."""
    q, c = as_f32(query_embeddings), as_f32(candidate_embeddings)
    if q.shape[0] * c.shape[0] > _BLOCK_THRESHOLD:
        ranks = diagonal_ranks_blocked(q, c)
    else:
        ranks = diagonal_ranks(q @ c.T)
    return _prefixed(_to_float(_rank_metrics(ranks, tuple(k_values), compute_recall, compute_mrr)), prefix)


def compute_retrieval_metrics_final(
    query_embeddings,
    target_embeddings,
    image_embeddings,
    prefix: str = "",
    k_values: Sequence[int] = DEFAULT_KS,
    compute_recall: bool = True,
    compute_mrr: bool = True,
    t2i_weight: float = 0.5,
    t2t_weight: float = 0.5,
) -> Dict[str, float]:
    """Weighted T2I+T2T blended-matrix metrics; blockwise above the threshold."""
    q, t, i = as_f32(query_embeddings), as_f32(target_embeddings), as_f32(image_embeddings)
    if q.shape[0] * i.shape[0] > _BLOCK_THRESHOLD:
        ranks = blended_diagonal_ranks_blocked(q, t, i, t2i_weight, t2t_weight)
    else:
        ranks = diagonal_ranks(float(t2i_weight) * (q @ i.T) + float(t2t_weight) * (q @ t.T))
    return _prefixed(_to_float(_rank_metrics(ranks, tuple(k_values), compute_recall, compute_mrr)), prefix)


def compute_retrieval_metrics_fusion(
    similarity_matrix,
    prefix: str = "",
    k_values: Sequence[int] = DEFAULT_KS,
    compute_recall: bool = True,
    compute_mrr: bool = True,
) -> Dict[str, float]:
    """Metrics from a precomputed (fused) similarity matrix."""
    ranks = diagonal_ranks(similarity_matrix)
    return _prefixed(_to_float(_rank_metrics(ranks, k_values, compute_recall, compute_mrr)), prefix)


def compute_all_retrieval_metrics(
    query_embeddings,
    target_embeddings,
    image_embeddings,
    k_values: Sequence[int] = DEFAULT_KS,
    tasks: Sequence[str] = DEFAULT_TASKS,
    compute_recall: bool = True,
    compute_mrr: bool = True,
) -> Dict[str, float]:
    """Three tasks: T2I query -> image, I2T image -> target, T2T query -> target."""
    metrics: Dict[str, float] = {}
    pairs = {
        "T2I": (query_embeddings, image_embeddings),
        "I2T": (image_embeddings, target_embeddings),
        "T2T": (query_embeddings, target_embeddings),
    }
    for task in tasks:
        q, c = pairs[task]
        metrics.update(compute_retrieval_metrics(
            q, c, prefix=task, k_values=k_values, compute_recall=compute_recall, compute_mrr=compute_mrr))
    return metrics


def compute_training_metrics(query_embeddings, target_embeddings, image_embeddings,
                             tasks: Sequence[str] = DEFAULT_TASKS) -> Dict[str, float]:
    """MRR-only path for in-training validation."""
    return compute_all_retrieval_metrics(
        query_embeddings, target_embeddings, image_embeddings, tasks=tasks, compute_recall=False, compute_mrr=True
    )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _prefixed(metrics: Dict[str, float], prefix: str) -> Dict[str, float]:
    if not prefix:
        return metrics
    return {f"{prefix}_{k}": v for k, v in metrics.items()}


def _to_float(metrics: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def average_mrr(metrics: Mapping[str, float], tasks: Sequence[str] = DEFAULT_TASKS) -> float:
    """Average MRR across tasks — the early-stop signal."""
    vals = [metrics[f"{t}_MRR"] for t in tasks if f"{t}_MRR" in metrics]
    return float(np.mean(vals)) if vals else 0.0
