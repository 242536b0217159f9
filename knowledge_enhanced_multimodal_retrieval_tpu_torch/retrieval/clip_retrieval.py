"""CLIP retriever: query text -> ranked corpus matches, on one device.

Counterpart of ``CLIPRetrieval`` in
``knowledge_enhanced_multimodal_retrieval_tpu/retrieval/clip_retrieval.py``,
restricted to the text-query search path:

    tokenize -> trim to the length bucket -> encode -> L2-normalize
    -> blended two-tower top-k -> row indices to uuids

with the exact (bf16 / f32) and int8 corpus modes and the flax (module
tower), fast (bf16 fused layers) and int8 (W8A8 layers) encoders. Every
tensor lives on the explicit ``device``; CUDA runs the hand-written
kernels, the CPU their plain versions. The search runs eagerly (no
per-bucket compiled program). Options of the JAX retriever that this port
does not carry yet raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.tokenizer import CLIPTokenizer, trim_to_bucket
from ..models.clip import TextTransformer, l2_normalize
from ..models.fast_encode import encode_text_fast, make_text_plan
from ..ops.similarity import fused_similarity_topk, fused_similarity_topk_q8, quantize_corpus_host
from .embedding_store import EmbeddingStore

# options of the JAX retriever outside this port's slice -> ROADMAP item
_NOT_PORTED = {
    "rt": "A8 (parallel modes)",
    "shard_corpus": "A8 (parallel modes)",
    "shard_queries": "A8 (parallel modes)",
    "ann": "A4 (capacity tiers: IVF)",
    "rerank": "A4 (capacity tiers: host rerank)",
    "truncate_dim": "A4 (capacity tiers: Matryoshka)",
    "rotate": "A4 (capacity tiers: rotation)",
    "pq_m": "A4 (capacity tiers: PQ)",
    "pq_aniso_t": "A4 (capacity tiers: PQ)",
}
_NOT_PORTED_CORPUS = {
    "int4": "A3 (int4 tier)",
    "pq": "A4 (capacity tiers: PQ)",
    "binary": "A4 (capacity tiers: binary)",
}


@dataclass(frozen=True)
class _CorpusState:
    """Everything search reads that depends on the corpus, as ONE object, so
    a corpus update is an atomic reference swap."""

    store: EmbeddingStore  # capacity-padded; row-aligned with the device arrays
    n_real: int  # rows before padding
    corpus_img: torch.Tensor  # [N, D] corpus dtype, or int8
    corpus_txt: torch.Tensor
    corpus_img_scale: Optional[torch.Tensor]  # int8 per-row scales [N, 1], else None
    corpus_txt_scale: Optional[torch.Tensor]
    top_k: int  # requested k clamped to the real row count


class CLIPRetrieval:
    """Query-text retrieval over a precomputed :class:`EmbeddingStore`."""

    def __init__(
        self,
        model: TextTransformer,
        tokenizer: CLIPTokenizer,
        store: EmbeddingStore,
        *,
        device,
        top_k: int = 100,
        corpus_dtype: torch.dtype = torch.float32,
        use_fused_encoder: bool = True,
        quantize: Optional[str] = None,
        quantize_corpus=False,
        capacity_multiple: int = 1,
        **options,
    ):
        for name, value in options.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected argument {name!r}")
            if value not in (None, False, 0, 0.0):
                raise NotImplementedError(
                    f"CLIPRetrieval({name}=...) is not ported yet: ROADMAP {_NOT_PORTED[name]}"
                )
        if quantize_corpus is True:
            quantize_corpus = "int8"
        if quantize_corpus in _NOT_PORTED_CORPUS:
            raise NotImplementedError(
                f"quantize_corpus={quantize_corpus!r} is not ported yet: "
                f"ROADMAP {_NOT_PORTED_CORPUS[quantize_corpus]}"
            )
        if quantize_corpus not in (False, None, "int8"):
            raise ValueError(f"unknown quantize_corpus mode {quantize_corpus!r}")
        if quantize is not None and not use_fused_encoder:
            raise ValueError("quantize requires use_fused_encoder=True")
        if tokenizer.vocab_size > model.arch.vocab_size:
            # an id past the embedding table would raise (CPU) or trip a
            # device assert (CUDA) at the first query
            raise ValueError(
                f"tokenizer vocab {tokenizer.vocab_size} exceeds the model's {model.arch.vocab_size}"
            )
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self._requested_top_k = top_k
        self.corpus_dtype = corpus_dtype
        self.capacity_multiple = max(1, int(capacity_multiple))
        self.use_fused_encoder = use_fused_encoder
        self.quantize = quantize
        self.quantize_corpus = quantize_corpus or False
        self._text_plan = (
            make_text_plan(self.model, dtype=model.dtype, quantize=quantize) if use_fused_encoder else None
        )
        self._update_lock = threading.Lock()
        self._install_corpus(store)

    # -- corpus state ----------------------------------------------------------

    def _install_corpus(self, store: EmbeddingStore) -> None:
        """Build the corpus device state and swap it in atomically."""
        if len(store) == 0:
            raise ValueError("empty corpus")
        n_real = len(store)
        # pad rows (zero vectors, score 0, sentinel uuids) round the device
        # arrays up to the capacity bucket
        padded = store.padded(self.capacity_multiple)
        if self.quantize_corpus:
            # quantized on the host: the f32 corpus never stages on the device
            to_dev = lambda a: torch.as_tensor(a).to(self.device).contiguous()  # noqa: E731
            qi, si = quantize_corpus_host(padded.image)
            qt, st = quantize_corpus_host(padded.text)
            cimg, cimg_s, ctxt, ctxt_s = to_dev(qi), to_dev(si), to_dev(qt), to_dev(st)
        else:
            cimg, ctxt = padded.device_arrays(self.corpus_dtype, self.device)
            cimg_s = ctxt_s = None
        self._corpus = _CorpusState(
            store=padded, n_real=n_real, corpus_img=cimg, corpus_txt=ctxt,
            corpus_img_scale=cimg_s, corpus_txt_scale=ctxt_s,
            top_k=min(self._requested_top_k, n_real),
        )

    @property
    def store(self) -> EmbeddingStore:
        return self._corpus.store

    @property
    def top_k(self) -> int:
        return self._corpus.top_k

    def add_documents(self, image: np.ndarray, text: np.ndarray, uuids: Sequence[str]) -> None:
        """Append documents (L2-normalized [n, D] tower embeddings + uuids)."""
        with self._update_lock:
            self._install_corpus(self._corpus_real_store().with_added(image, text, uuids))

    def remove_documents(self, uuids: Sequence[str]) -> None:
        """Retire documents by uuid (unknown uuids raise KeyError)."""
        with self._update_lock:
            self._install_corpus(self._corpus_real_store().with_removed(uuids))

    def _corpus_real_store(self) -> EmbeddingStore:
        c = self._corpus
        if len(c.store) == c.n_real:
            return c.store
        return EmbeddingStore(
            image=c.store.image[: c.n_real], text=c.store.text[: c.n_real], uuids=c.store.uuids[: c.n_real]
        )

    # -- core ----------------------------------------------------------------

    def _tokenize(self, queries: Sequence[str]) -> np.ndarray:
        ids = self.tokenizer(list(queries), context_length=self.model.arch.context_length)
        return trim_to_bucket(ids)

    def seq_bucket(self, query: str) -> int:
        """The seq bucket this query encodes at."""
        return int(self._tokenize([query]).shape[1])

    @torch.no_grad()
    def encode_queries(self, queries: Sequence[str]) -> torch.Tensor:
        """Queries -> L2-normalized [B, D] f32 embeddings on the device."""
        ids = torch.as_tensor(self._tokenize(queries), dtype=torch.long).to(self.device)
        if self.use_fused_encoder:
            q = encode_text_fast(self.model.arch, self._text_plan, ids)
        else:
            q = self.model(ids)
        return l2_normalize(q)

    def search_batch(self, queries: Sequence[str], alpha=0.5, top_k: Optional[int] = None):
        """Batched search: ``(values [Q, k_fetch], rows [Q, k_fetch])`` device
        tensors; ``k_fetch >= k`` over-fetches past capacity-pad rows — use
        :meth:`results_from_topk` or :meth:`retrieval_batch` to filter."""
        return self._search_state(self._corpus, queries, alpha, top_k)

    @torch.no_grad()
    def _search_state(self, c: _CorpusState, queries: Sequence[str], alpha, top_k: Optional[int]):
        k = min(top_k or c.top_k, c.n_real)
        q = self.encode_queries(queries)
        return self._score(c, q, alpha, self._k_fetch(c, k))

    def _score(self, c: _CorpusState, q: torch.Tensor, alpha, k: int):
        if self.quantize_corpus:
            q = q.to(self.model.dtype).contiguous()
            return fused_similarity_topk_q8(
                q, c.corpus_img, c.corpus_img_scale, c.corpus_txt, c.corpus_txt_scale, k=k, alpha=alpha
            )
        q = q.to(c.corpus_img.dtype).contiguous()
        return fused_similarity_topk(q, c.corpus_img, c.corpus_txt, k=k, alpha=alpha)

    def _k_fetch(self, c: _CorpusState, k: int) -> int:
        """Pad rows score exactly 0 and could displace negative-scoring real
        matches: over-fetch by the bucket's maximum pad count."""
        return min(k + self.capacity_multiple - 1, len(c.store))

    # -- reference-parity API --------------------------------------------------

    def results_from_topk(
        self, vals: np.ndarray, idx: np.ndarray, _state: Optional[_CorpusState] = None,
        top_k: Optional[int] = None,
    ) -> List[List[Dict]]:
        """[Q, k] winners -> per-query ``[{"uuid", "score"}]`` lists, dropping
        capacity-pad rows and truncating to ``top_k``."""
        uuids = (_state or self._corpus).store.uuids
        results: List[List[Dict]] = []
        for row_vals, row_idx in zip(vals, idx):
            out = []
            for v, i in zip(row_vals.tolist(), row_idx.tolist()):
                if i < 0:
                    continue
                uuid = uuids[i]
                if uuid.startswith("__pad_"):
                    continue
                out.append({"uuid": uuid, "score": v})
                if top_k is not None and len(out) >= top_k:
                    break
            results.append(out)
        return results

    def retrieval_batch(self, queries: Sequence[str], alpha=0.5, top_k: Optional[int] = None) -> List[List[Dict]]:
        """Batched search -> one ``[{"uuid", "score"}]`` list per query.
        ``alpha`` may be a scalar or one blend per query."""
        c = self._corpus  # one snapshot: search and uuid mapping stay aligned
        k = min(top_k or c.top_k, c.n_real)
        vals, idx = self._search_state(c, queries, alpha, top_k)
        return self.results_from_topk(
            vals.float().cpu().numpy(), idx.cpu().numpy(), _state=c, top_k=k
        )

    def retrieval(self, query: str, alpha: float = 0.5, top_k: Optional[int] = None) -> List[Dict]:
        """Single-query search -> ``[{"uuid", "score"}]`` sorted descending."""
        return self.retrieval_batch([query], alpha=alpha, top_k=top_k)[0]
