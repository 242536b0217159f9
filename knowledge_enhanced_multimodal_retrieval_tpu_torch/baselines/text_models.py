"""Text-only retrieval baselines (MPNet / E5 / GTE).

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/baselines/text_models.py``,
the re-design of the reference's ``baselines/evaluate_text_models.py``: the
sentence encoder is behind a protocol (sentence-transformers, or a
deterministic hash encoder for tests and runs without weights), and the
per-rank Python loops (``evaluate_text_models.py:193-224``) become one
grouped-rank computation on ``device`` (the card unless the caller asks
for the CPU): the similarity products and the ranks run in torch there.

Evaluation protocol (``evaluate_text_models.py:96-283``):
- every artifact has 5 text variants;
- *single* mode: variant 0 queries the pool of variants 1-4 of every
  artifact (N queries x 4N candidates);
- *multi* mode: each variant v queries the other 4 variants' pool, metrics
  averaged over all 5 query roles;
- grouped ground truth: a query "hits" at the rank of its artifact's
  best-scoring candidate (``rank = 1 + #{j : s_ij > best_i}``, strict).
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Dict, List, Protocol, Sequence

import numpy as np
import torch

from ..eval.metrics import DEFAULT_KS, as_f32

DESC_KEY_MAP = {
    "content": "content_descriptions",
    "metadata": "metadata_descriptions",
    "hybrid_o1": "hybrid_descriptions",
    "hybrid_o2": "hybrid_descriptions",
}


class TextEncoder(Protocol):
    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """Return [N, D] L2-normalized embeddings."""
        ...


class SentenceTransformerEncoder:
    """sentence-transformers wrapper (``evaluate_text_models.py:145-152``)."""

    def __init__(self, model_name: str, device: str = "cuda", batch_size: int = 32):
        from sentence_transformers import SentenceTransformer

        self.model = SentenceTransformer(model_name, device=device)
        self.batch_size = batch_size

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        emb = self.model.encode(
            list(texts), batch_size=self.batch_size, show_progress_bar=False, normalize_embeddings=True
        )
        emb = np.asarray(emb, np.float32)
        return emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)


class HashTextEncoder:
    """Deterministic offline encoder for tests: same text -> same embedding."""

    def __init__(self, dim: int = 32):
        self.dim = dim

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, t in enumerate(texts):
            digest = hashlib.md5(t.encode()).digest() * ((self.dim * 4) // 16 + 1)
            out[i] = np.frombuffer(digest[: self.dim * 4], np.uint8)[:: 4].astype(np.float32)
        out += 1e-3
        return out / np.linalg.norm(out, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# Variant loading (TextOnlyDataset, evaluate_text_models.py:28-81)
# ---------------------------------------------------------------------------


def load_text_variants(
    uuids: Sequence[str],
    text_folder: str,
    description_type: str,
    num_variants: int = 5,
) -> List[List[str]]:
    """Per-uuid list of ``num_variants`` texts (missing/blank -> '')."""
    folder = Path(text_folder)
    key = DESC_KEY_MAP[description_type]
    out: List[List[str]] = []
    for uuid in uuids:
        texts = [""] * num_variants
        try:
            with open(folder / f"{uuid}.json", encoding="utf-8") as f:
                descriptions = json.load(f).get(key, [])
            for i in range(num_variants):
                if i < len(descriptions) and str(descriptions[i]).strip():
                    texts[i] = descriptions[i]
        except Exception:
            pass
        out.append(texts)
    return out


# ---------------------------------------------------------------------------
# Grouped-rank metrics
# ---------------------------------------------------------------------------


def grouped_ranks(similarity: torch.Tensor, col_to_group: torch.Tensor) -> torch.Tensor:
    """``rank_i = 1 + #{j : s_ij > max_{j in group i} s_ij}`` for an
    ``[N, M]`` similarity and an ``[M]`` column -> artifact map: the position
    of the first matching artifact in the reference's argsort walk
    (``evaluate_text_models.py:193-224``) up to tie order. [N] int64."""
    n = similarity.shape[0]
    mask = col_to_group[None, :] == torch.arange(n, device=similarity.device)[:, None]
    best = torch.where(mask, similarity, torch.full_like(similarity, -float("inf"))).amax(dim=1)
    return 1 + torch.sum(similarity > best[:, None], dim=1)


def _metrics(ranks: torch.Tensor, k_values: Sequence[int], prefix: str) -> Dict[str, float]:
    r = ranks.float()
    metrics = {f"{prefix}_R@{k}": float(torch.mean((ranks <= k).float()) * 100) for k in k_values}
    metrics[f"{prefix}_MRR"] = float(torch.mean(1.0 / r) * 100)
    metrics[f"{prefix}_Mean_Rank"] = float(torch.mean(r))
    return metrics


def grouped_retrieval_metrics(
    similarity,  # [N, M]
    col_to_group,  # [M] int: candidate column -> artifact index
    k_values: Sequence[int] = DEFAULT_KS,
    prefix: str = "T2T",
    device="cuda",
) -> Dict[str, float]:
    """Grouped-rank Recall@K / MRR / Mean Rank on ``device`` (a tensor
    argument stays on its own device)."""
    sim = as_f32(similarity, None if torch.is_tensor(similarity) else device)
    groups = torch.as_tensor(np.asarray(col_to_group), device=sim.device)
    return _metrics(grouped_ranks(sim, groups), k_values, prefix)


# ---------------------------------------------------------------------------
# Evaluation modes
# ---------------------------------------------------------------------------


def _pool(embeddings_by_variant: List[torch.Tensor], exclude_variant: int):
    """Candidate pool of all variants except one: [N * (V - 1), D] + group
    map. Column order is artifact-major (artifact 0's variants first), the
    reference's pool construction (``evaluate_text_models.py:179-186``)."""
    kept = torch.stack([e for v, e in enumerate(embeddings_by_variant) if v != exclude_variant], dim=1)
    n, vv, d = kept.shape
    groups = torch.arange(n, device=kept.device).repeat_interleave(vv)
    return kept.reshape(n * vv, d), groups


def evaluate_text_model(
    encoder: TextEncoder,
    texts_per_artifact: Sequence[Sequence[str]],
    mode: str = "multi",
    k_values: Sequence[int] = DEFAULT_KS,
    device="cuda",
) -> Dict[str, float]:
    """Run the single/multi variant-retrieval protocol; the encoder runs
    where it runs, the products and ranks on ``device``."""
    if mode not in ("single", "multi"):
        raise ValueError(f"unknown mode {mode!r}")
    num_variants = len(texts_per_artifact[0])
    embeddings_by_variant = [
        as_f32(encoder.encode([t[v] for t in texts_per_artifact]), device) for v in range(num_variants)
    ]

    if mode == "single":
        pool, groups = _pool(embeddings_by_variant, exclude_variant=0)
        return _metrics(grouped_ranks(embeddings_by_variant[0] @ pool.T, groups), k_values, "T2T")

    # multi: average the *sample-level* statistics over all query roles
    # (the reference pools per-sample recalls/ranks, :229-278)
    ranks = []
    for qv in range(num_variants):
        pool, groups = _pool(embeddings_by_variant, exclude_variant=qv)
        ranks.append(grouped_ranks(embeddings_by_variant[qv] @ pool.T, groups))
    r = torch.cat(ranks).cpu().numpy()
    metrics = {f"T2T_R@{k}": float(np.mean(r <= k) * 100) for k in k_values}
    metrics["T2T_MRR"] = float(np.mean(1.0 / r) * 100)
    metrics["T2T_Mean_Rank"] = float(np.mean(r))
    return metrics


# ---------------------------------------------------------------------------
# Query -> target LM baseline (reference evaluator_lm.py)
# ---------------------------------------------------------------------------


def evaluate_lm_query_target(
    encoder: TextEncoder,
    queries: Sequence[str],
    targets: Sequence[str],
    k_values: Sequence[int] = DEFAULT_KS,
    prefix: str = "T2T",
    mrr_only: bool = False,
    device="cuda",
) -> Dict[str, float]:
    """T2T retrieval with a text-only model: encode queries and targets,
    diagonal ground truth (``evaluator_lm.py:41-132``; the MRR-only training
    variant is ``:136-165``), the metrics on ``device``."""
    from ..eval.metrics import compute_retrieval_metrics

    if len(queries) != len(targets):
        raise ValueError("queries and targets must be aligned")
    q = as_f32(encoder.encode(queries), device)
    t = as_f32(encoder.encode(targets), device)
    return compute_retrieval_metrics(
        q, t, prefix=prefix, k_values=k_values, compute_recall=not mrr_only, compute_mrr=True
    )
