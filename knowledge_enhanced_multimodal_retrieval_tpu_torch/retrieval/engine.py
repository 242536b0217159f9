"""RetrievalEngine: the knowledge-enhanced serving API, text queries.

The port's copy of the text-query half of
``knowledge_enhanced_multimodal_retrieval_tpu/retrieval/engine.py``:

- ``retrieve_text(query, alpha=0.8, beta=0.2, alpha_clip=0.5, threshold=0)``
  — CLIP results fused with Text2SPARQL uuid hits by
  ``score = alpha * clip + beta * 1[uuid in sparql]``, sorted descending,
  rounded to 4 decimals, threshold-filtered;
- ``retrieve_text_noknowledge(...)`` — CLIP only;
- their ``_batch`` forms (one device search per batch; Text2SPARQL calls fan
  out over threads).

The Text2SPARQL side and ``FusionConfig`` are the JAX package's jax-free
``knowledge.*`` and ``utils.config`` modules, used as they are.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from knowledge_enhanced_multimodal_retrieval_tpu.utils.config import FusionConfig

from .clip_retrieval import CLIPRetrieval


class RetrievalEngine:
    def __init__(self, clip_retriever: CLIPRetrieval, t2s_retriever=None, fusion: FusionConfig = FusionConfig()):
        self.clip_retriever = clip_retriever
        self.t2s_retriever = t2s_retriever
        self.fusion = fusion

    @staticmethod
    def _fuse_clip_sparql_linear(
        clip_results: List[Dict], sparql_results: Sequence[str], alpha: float = 0.8, beta: float = 0.2
    ) -> List[Dict]:
        """Linear fusion without normalization (CLIP cosine scores are bounded)."""
        if not clip_results:
            return []
        sparql_set = set(sparql_results)
        fused = [
            {
                "uuid": item["uuid"],
                "score": round(alpha * item["score"] + beta * (1.0 if item["uuid"] in sparql_set else 0.0), 4),
            }
            for item in clip_results
        ]
        fused.sort(key=lambda x: x["score"], reverse=True)
        return fused

    def retrieve_text(
        self,
        query: str,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        alpha_clip: Optional[float] = None,
        threshold: Optional[float] = None,
    ) -> List[Dict]:
        """Knowledge-enhanced retrieval."""
        alpha = self.fusion.alpha if alpha is None else alpha
        beta = self.fusion.beta if beta is None else beta
        alpha_clip = self.fusion.alpha_clip if alpha_clip is None else alpha_clip
        threshold = self.fusion.threshold if threshold is None else threshold
        clip_results = self.clip_retriever.retrieval(query, alpha=alpha_clip)
        t2s_results = self.t2s_retriever.retrieval(query) if self.t2s_retriever is not None else []
        fused = self._fuse_clip_sparql_linear(clip_results, t2s_results, alpha=alpha, beta=beta)
        return self._apply_threshold(fused, threshold)

    def retrieve_text_noknowledge(
        self,
        query: str,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        alpha_clip: Optional[float] = None,
        threshold: Optional[float] = None,
    ) -> List[Dict]:
        """CLIP-only retrieval."""
        alpha_clip = self.fusion.alpha_clip if alpha_clip is None else alpha_clip
        threshold = self.fusion.threshold if threshold is None else threshold
        results = self.clip_retriever.retrieval(query, alpha=alpha_clip)
        return self._apply_threshold(results, threshold)

    def retrieve_text_batch(
        self,
        queries: Sequence[str],
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        alpha_clip=None,
        threshold: Optional[float] = None,
        max_workers: int = 8,
    ) -> List[List[Dict]]:
        """Knowledge-enhanced retrieval for a batch; ``alpha_clip`` may be a
        scalar or one blend per query."""
        alpha = self.fusion.alpha if alpha is None else alpha
        beta = self.fusion.beta if beta is None else beta
        alpha_clip = self.fusion.alpha_clip if alpha_clip is None else alpha_clip
        threshold = self.fusion.threshold if threshold is None else threshold
        clip_lists = self.clip_retriever.retrieval_batch(queries, alpha=alpha_clip)
        t2s_lists = self._t2s_batch(queries, max_workers)
        out: List[List[Dict]] = []
        for clip_results, t2s_results in zip(clip_lists, t2s_lists):
            fused = self._fuse_clip_sparql_linear(clip_results, t2s_results, alpha=alpha, beta=beta)
            out.append(self._apply_threshold(fused, threshold))
        return out

    def _t2s_batch(self, queries: Sequence[str], max_workers: int = 8) -> List[Sequence[str]]:
        """Text2SPARQL uuid hits for a batch, one call per distinct query."""
        if self.t2s_retriever is None:
            return [[] for _ in queries]
        import concurrent.futures as cf

        unique = list(dict.fromkeys(queries))
        with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
            per_unique = dict(zip(unique, pool.map(self.t2s_retriever.retrieval, unique)))
        return [per_unique[q] for q in queries]

    def retrieve_text_noknowledge_batch(
        self,
        queries: Sequence[str],
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        alpha_clip=None,
        threshold: Optional[float] = None,
    ) -> List[List[Dict]]:
        """CLIP-only batch retrieval."""
        alpha_clip = self.fusion.alpha_clip if alpha_clip is None else alpha_clip
        threshold = self.fusion.threshold if threshold is None else threshold
        clip_lists = self.clip_retriever.retrieval_batch(queries, alpha=alpha_clip)
        return [self._apply_threshold(results, threshold) for results in clip_lists]

    @staticmethod
    def _apply_threshold(results: List[Dict], threshold: float) -> List[Dict]:
        return [
            {"uuid": item["uuid"], "score": item["score"]}
            for item in results
            if item.get("score", 0) >= threshold
        ]
