"""Serving-config autotuner: pick the cheapest corpus packing that meets a
recall target ON YOUR EMBEDDINGS.

The port's copy of ``knowledge_enhanced_multimodal_retrieval_tpu/eval/autotune.py``:
host code over the rows of the port's quality sweep (:mod:`eval.quality`),
which runs on ``device`` (``cuda`` by default).

The packing ladder (exact → int8 → int4 → binary, each optionally rotated
and/or host-reranked) trades recall for corpus capacity per chip. The
quality sweep (:mod:`eval.quality`) measures what each rung costs; this
module turns those measurements into a decision: *the highest-capacity
configuration whose measured recall@k meets the target*, plus the exact
``CLIPRetrieval`` kwargs and serve-CLI flags that enable it.

Run ``python -m knowledge_enhanced_multimodal_retrieval_tpu_torch.scripts.autotune
--store store.npz --recall-target 0.98``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from .quality import quality_sweep

# f32 corpus bytes/dim for each packing mode (scales/overheads are O(1/D)
# per row and ignored); capacity multiplier = 4 / bytes_per_dim. pq uses the
# default m = D/8 subspaces -> one uint8 code per 8 dims.
_BYTES_PER_DIM = {
    "exact": 4.0, "int8": 1.0, "int4": 0.5, "pq": 1.0 / 8.0, "binary": 1.0 / 32.0,
}


def _parse_config(name: str) -> Optional[Dict]:
    """Sweep row name -> CLIPRetrieval kwargs (None for non-packing rows)."""
    m = re.fullmatch(r"(exact|int8|int4|pq|binary)(\+rot|\+opq)?(?:\+rerank(\d+)x)?", name)
    if not m:
        return None  # ivf / trunc rows are tuned separately
    mode, rot, factor = m.group(1), m.group(2), m.group(3)
    kwargs: Dict = {}
    if mode != "exact":
        kwargs["quantize_corpus"] = mode
    if rot:
        kwargs["rotate"] = "opq" if rot == "+opq" else True
    if factor:
        kwargs["rerank"] = True
        kwargs["rerank_factor"] = int(factor)
    return {
        "mode": mode,
        "kwargs": kwargs,
        "bytes_per_dim": _BYTES_PER_DIM[mode],
        "capacity_multiplier": 4.0 / _BYTES_PER_DIM[mode],
        "reranked": bool(factor),
    }


def serve_flags(kwargs: Dict, rotate_seed: int = 0) -> str:
    """The serve-CLI flags that reproduce a recommendation's kwargs."""
    flags = []
    if kwargs.get("quantize_corpus"):
        flags.append(f"--eval.quantize_corpus={kwargs['quantize_corpus']}")
    if kwargs.get("rotate"):
        flags.append("--eval.rotate=true")
        if kwargs["rotate"] == "opq":
            flags.append("--eval.rotate_mode=opq")
        if rotate_seed:
            flags.append(f"--eval.rotate_seed={rotate_seed}")
    if kwargs.get("rerank"):
        flags.append("--eval.rerank=true")
        flags.append(f"--eval.rerank_factor={kwargs['rerank_factor']}")
    return " ".join(flags)


def recommend_config(
    image: np.ndarray,
    text: np.ndarray,
    queries: Optional[np.ndarray] = None,
    *,
    recall_target: float = 0.98,
    k: int = 10,
    alpha: float = 0.5,
    rerank_factor: int = 4,
    rerank_ok: bool = True,
    rotate: bool = True,
    rotate_seed: int = 0,
    n_queries: int = 256,
    seed: int = 0,
    device="cuda",
) -> Dict:
    """Measure the packing ladder and pick the highest-capacity rung that
    meets ``recall_target`` at ``recall@k``.

    ``queries`` defaults to a sample of the text tower (the store's own
    distribution — right when no query log exists yet). ``rerank_ok=False``
    excludes host-rerank configs (e.g. a rerank-hostile host); ``rotate``
    includes the ``+rot`` rungs. Ties at equal capacity prefer no-rerank
    (no host cost), then no-rotation (one fewer moving part). The sweep
    runs on ``device``. Returns::

        {"config", "kwargs", "serve_flags", "predicted_recall_at_k",
         "capacity_multiplier", "bytes_per_dim", "recall_target", "k",
         "rows": [...all measured rows...]}

    Raises ``ValueError`` if nothing meets the target (cannot happen with
    ``exact`` in the ladder unless the target exceeds 1.0).
    """
    if not 0.0 < recall_target <= 1.0:
        raise ValueError(f"recall_target must be in (0, 1], got {recall_target}")
    image = np.asarray(image, np.float32)
    text = np.asarray(text, np.float32)
    if queries is None:
        rng = np.random.default_rng(seed)
        rows = rng.choice(len(text), min(n_queries, len(text)), replace=False)
        queries = text[rows]
    rows = quality_sweep(
        image, text, np.asarray(queries, np.float32),
        k=k, alpha=alpha, rerank_factor=rerank_factor,
        rotate=rotate, rotate_seed=rotate_seed, device=device,
    )

    candidates: List[Dict] = []
    for r in rows:
        parsed = _parse_config(r["config"])
        if parsed is None:
            continue
        if parsed["reranked"] and not rerank_ok:
            continue
        if parsed["mode"] == "binary" and not parsed["reranked"]:
            continue  # serving refuses raw binary (proxy scores)
        if r["recall_at_k"] + 1e-9 < recall_target:
            continue
        candidates.append({**parsed, "row": r})
    if not candidates:
        raise ValueError(
            f"no configuration met recall@{k} >= {recall_target} "
            f"(best rows: {sorted(rows, key=lambda r: -r['recall_at_k'])[:3]})"
        )
    # highest capacity first; ties prefer no-rerank, then no-rotation
    candidates.sort(
        key=lambda c: (
            -c["capacity_multiplier"],
            c["reranked"],
            bool(c["kwargs"].get("rotate")),
        )
    )
    best = candidates[0]
    return {
        "config": best["row"]["config"],
        "kwargs": best["kwargs"],
        "serve_flags": serve_flags(best["kwargs"], rotate_seed),
        "predicted_recall_at_k": best["row"]["recall_at_k"],
        "capacity_multiplier": best["capacity_multiplier"],
        "bytes_per_dim": best["bytes_per_dim"],
        "recall_target": recall_target,
        "k": k,
        "rows": rows,
    }
