"""RetrievalEngine: the knowledge-enhanced serving API.

The port's copy of the text- and image-query API of
``knowledge_enhanced_multimodal_retrieval_tpu/retrieval/engine.py``:

- ``retrieve_text(query, alpha=0.8, beta=0.2, alpha_clip=0.5, threshold=0)``
  — CLIP results fused with Text2SPARQL uuid hits by
  ``score = alpha * clip + beta * 1[uuid in sparql]``, sorted descending,
  rounded to 4 decimals, threshold-filtered;
- ``retrieve_text_noknowledge(...)`` — CLIP only;
- their ``_batch`` forms (one device search per batch; Text2SPARQL calls fan
  out over threads);
- ``retrieve_image`` / ``retrieve_image_batch`` — visual search, CLIP only
  (Text2SPARQL has no image modality);
- ``retrieve_text_filtered{,_batch}`` — uuid allow / deny hard filters,
  then the same fusion;
- ``retrieve_text_constrained{,_batch}`` — only the Text2SPARQL hits are
  scored (exact, on the host), with a fallback to the unconstrained search
  when the knowledge graph returns nothing;
- ``retrieve_text_noknowledge_batches`` — the streaming CLIP-only mode.

- ``set_fusion_head`` + ``retrieve_text_fused{,_batch}`` — a trained
  fusion head rescores the CLIP candidates, then the same Text2SPARQL bonus.

The Text2SPARQL side and ``FusionConfig`` are the port's own copies of the
reference package's ``knowledge.*`` and ``utils.config`` modules.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from ..utils.config import FusionConfig

from .clip_retrieval import CLIPRetrieval


class RetrievalEngine:
    def __init__(self, clip_retriever: CLIPRetrieval, t2s_retriever=None, fusion: FusionConfig = FusionConfig()):
        self.clip_retriever = clip_retriever
        self.t2s_retriever = t2s_retriever
        self.fusion = fusion
        self.fusion_head = None  # (FusionModel, head module) via set_fusion_head
        self._fusion_factor = 4

    def set_fusion_head(self, fm, params, factor: int = 4) -> None:
        """Attach a trained fusion head (``models.fusion_heads.FusionModel`` and
        its head module, e.g. from ``train.fusion_trainer.load_fusion_head``)
        for :meth:`retrieve_text_fused`; ``factor * top_k`` candidates are
        fetched for it per query."""
        self.fusion_head = (fm, params)
        self._fusion_factor = factor

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

    def retrieve_image(
        self, image, alpha_clip: Optional[float] = None, threshold: Optional[float] = None
    ) -> List[Dict]:
        """Image-query retrieval over the same corpus. ``alpha_clip`` blends
        the image embedding against the corpus image vs text towers (1.0 =
        pure image-to-image similarity)."""
        return self.retrieve_image_batch([image], alpha_clip, threshold)[0]

    def retrieve_image_batch(
        self, images: Sequence, alpha_clip: Optional[float] = None, threshold: Optional[float] = None
    ) -> List[List[Dict]]:
        """Batched visual search: one encode and one scan for the batch."""
        alpha_clip = self.fusion.alpha_clip if alpha_clip is None else alpha_clip
        threshold = self.fusion.threshold if threshold is None else threshold
        lists = self.clip_retriever.retrieval_image_batch(images, alpha=alpha_clip)
        return [self._apply_threshold(results, threshold) for results in lists]

    @staticmethod
    def _apply_threshold(results: List[Dict], threshold: float) -> List[Dict]:
        return [
            {"uuid": item["uuid"], "score": item["score"]}
            for item in results
            if item.get("score", 0) >= threshold
        ]

    # -- filtered and knowledge-constrained retrieval ----------------------------

    def retrieve_text_filtered(
        self,
        query: str,
        allow_uuids=None,
        deny_uuids=None,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        alpha_clip: Optional[float] = None,
        threshold: Optional[float] = None,
    ) -> List[Dict]:
        """Knowledge-enhanced retrieval restricted by uuid allow / deny lists:
        only eligible documents appear, and the SPARQL bonus reorders within
        them as in :meth:`retrieve_text`. Needs an exact corpus scan."""
        return self.retrieve_text_filtered_batch(
            [query], allow_uuids, deny_uuids, alpha, beta, alpha_clip, threshold
        )[0]

    def retrieve_text_filtered_batch(
        self,
        queries: Sequence[str],
        allow_uuids=None,
        deny_uuids=None,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        alpha_clip=None,
        threshold: Optional[float] = None,
        max_workers: int = 8,
    ) -> List[List[Dict]]:
        """Batched filtered retrieval: one masked search for the batch;
        Text2SPARQL fans out over threads when configured."""
        alpha = self.fusion.alpha if alpha is None else alpha
        beta = self.fusion.beta if beta is None else beta
        alpha_clip = self.fusion.alpha_clip if alpha_clip is None else alpha_clip
        threshold = self.fusion.threshold if threshold is None else threshold
        clip_lists = self.clip_retriever.retrieval_filtered_batch(queries, allow_uuids, deny_uuids, alpha=alpha_clip)
        t2s_lists = self._t2s_batch(queries, max_workers)
        return [
            self._apply_threshold(self._fuse_clip_sparql_linear(c, t, alpha=alpha, beta=beta), threshold)
            for c, t in zip(clip_lists, t2s_lists)
        ]

    def retrieve_text_constrained(
        self,
        query: str,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        alpha_clip: Optional[float] = None,
        threshold: Optional[float] = None,
        fallback: bool = True,
    ) -> List[Dict]:
        """Knowledge-constrained retrieval: only the Text2SPARQL uuid hits are
        scored (exact f32 on the host, any corpus mode), so the knowledge
        graph defines the candidates and CLIP ranks within them. With no KG
        hit, ``fallback=True`` answers as :meth:`retrieve_text` would without
        a bonus; ``False`` returns ``[]``."""
        return self.retrieve_text_constrained_batch([query], alpha, beta, alpha_clip, threshold, fallback)[0]

    def retrieve_text_constrained_batch(
        self,
        queries: Sequence[str],
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        alpha_clip=None,
        threshold: Optional[float] = None,
        fallback: bool = True,
        max_workers: int = 8,
    ) -> List[List[Dict]]:
        if self.t2s_retriever is None:
            raise ValueError("constrained retrieval needs a Text2SPARQL retriever")
        alpha = self.fusion.alpha if alpha is None else alpha
        beta = self.fusion.beta if beta is None else beta
        alpha_clip = self.fusion.alpha_clip if alpha_clip is None else alpha_clip
        threshold = self.fusion.threshold if threshold is None else threshold
        t2s_lists = self._t2s_batch(queries, max_workers)
        clip_lists = self.clip_retriever.retrieval_candidates_batch(queries, t2s_lists, alpha=alpha_clip)
        empties = [i for i, t in enumerate(t2s_lists) if not t]
        fb: Dict[int, List[Dict]] = {}
        if fallback and empties:
            fb_alpha = [alpha_clip[i] for i in empties] if isinstance(alpha_clip, (list, tuple)) else alpha_clip
            fb_lists = self.clip_retriever.retrieval_batch([queries[i] for i in empties], alpha=fb_alpha)
            fb = dict(zip(empties, fb_lists))
        out: List[List[Dict]] = []
        for i, (clip_results, t2s_results) in enumerate(zip(clip_lists, t2s_lists)):
            if not t2s_results:
                fused = self._fuse_clip_sparql_linear(fb.get(i, []), [], alpha=alpha, beta=beta)
            else:
                fused = self._fuse_clip_sparql_linear(clip_results, t2s_results, alpha=alpha, beta=beta)
            out.append(self._apply_threshold(fused, threshold))
        return out

    def retrieve_text_noknowledge_batches(
        self, query_batches, alpha_clip: Optional[float] = None, threshold: Optional[float] = None
    ):
        """Streaming CLIP-only retrieval over an iterable of query batches
        (:meth:`CLIPRetrieval.retrieval_batches`): later batches are launched
        while earlier results are fetched. Yields one ``List[List[Dict]]``
        per batch, in order."""
        alpha_clip = self.fusion.alpha_clip if alpha_clip is None else alpha_clip
        threshold = self.fusion.threshold if threshold is None else threshold
        for results in self.clip_retriever.retrieval_batches(query_batches, alpha=alpha_clip):
            yield [self._apply_threshold(r, threshold) for r in results]

    # -- learned-fusion serving ----------------------------------------------------

    def retrieve_text_fused(
        self,
        query: str,
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        alpha_clip: Optional[float] = None,
        threshold: Optional[float] = None,
    ) -> List[Dict]:
        """Retrieval scored by the attached trained head (stage 1 fetches
        the blended top-(factor * k) on the device, stage 2 rescores their
        exact f32 rows), then ``alpha * head_score + beta * hit`` and the
        threshold, as in :meth:`retrieve_text`."""
        return self.retrieve_text_fused_batch([query], alpha, beta, alpha_clip, threshold)[0]

    def retrieve_text_fused_batch(
        self,
        queries: Sequence[str],
        alpha: Optional[float] = None,
        beta: Optional[float] = None,
        alpha_clip=None,
        threshold: Optional[float] = None,
        max_workers: int = 8,
    ) -> List[List[Dict]]:
        if self.fusion_head is None:
            raise ValueError("no fusion head attached — call set_fusion_head first")
        fm, fparams = self.fusion_head
        alpha = self.fusion.alpha if alpha is None else alpha
        beta = self.fusion.beta if beta is None else beta
        alpha_clip = self.fusion.alpha_clip if alpha_clip is None else alpha_clip
        threshold = self.fusion.threshold if threshold is None else threshold
        clip_lists = self.clip_retriever.retrieval_fused_batch(
            queries, fm, fparams, alpha=alpha_clip, factor=self._fusion_factor
        )
        t2s_lists = self._t2s_batch(queries, max_workers)
        return [
            self._apply_threshold(self._fuse_clip_sparql_linear(c, t, alpha=alpha, beta=beta), threshold)
            for c, t in zip(clip_lists, t2s_lists)
        ]
