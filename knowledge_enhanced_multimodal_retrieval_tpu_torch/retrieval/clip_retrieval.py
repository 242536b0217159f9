"""CLIP retriever: query text or images -> ranked corpus matches, on one device.

Counterpart of ``CLIPRetrieval`` in
``knowledge_enhanced_multimodal_retrieval_tpu/retrieval/clip_retrieval.py``,
for the text-query and image-query search paths:

    tokenize -> trim to the length bucket -> encode text -> L2-normalize
    (or) preprocess -> encode images -> L2-normalize
    -> [truncate (Matryoshka)] -> [rotate] -> corpus tier top-k
    -> [exact f32 host rerank] -> row indices to uuids

with the flax (module towers), fast (bf16 fused layers) and int8 (W8A8
layers) encoders, and the JAX retriever's corpus ladder: exact (bf16 /
f32), int8 and int4 (kernel B2), product-quantized (kernel B5 on CUDA),
binary sign sketches, and IVF lists (exact / int8 / int4 / residual PQ),
each optionally rotated (random or OPQ) or truncated, with the host
rerank. Every tensor lives on the explicit ``device``; CUDA runs the
hand-written kernels, the CPU their plain versions. The search runs eagerly
(no per-bucket compiled program). Options of the JAX retriever that this
port does not carry yet raise ``NotImplementedError`` naming their ROADMAP
item.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import zipfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.preprocess import preprocess_pil
from ..data.tokenizer import CLIPTokenizer, trim_to_bucket
from ..models.clip import CLIP, l2_normalize
from ..models.fast_encode import encode_image_fast, encode_text_fast, make_text_plan, make_vision_plan
from ..ops.binary_sketch import hamming_topk, pack_sign_bits_host
from ..ops.pq import (
    pack_pq_host,
    pq_similarity_topk,
    train_opq_rotation,
    train_pq_codebooks,
    train_pq_codebooks_anisotropic,
)
from ..ops.similarity import (
    fused_similarity_topk,
    fused_similarity_topk_q4,
    fused_similarity_topk_q8,
    prefix_normalize,
    prefix_normalize_host,
    quantize_corpus_host,
    quantize_corpus_host_q4,
    random_rotation,
    rerank_scores_host,
)
from .ann import _SUBLANE as _CAP_SUBLANE
from .ann import IVFIndex, build_ivf_index, corpus_fingerprint, ivf_search, load_ivf_index, save_ivf_index
from .embedding_store import EmbeddingStore

# options of the JAX retriever outside this port's slice -> ROADMAP item
_NOT_PORTED = {
    "rt": "A5 (parallel modes)",
    "shard_corpus": "A5 (parallel modes)",
    "shard_queries": "A5 (parallel modes)",
}
_FILTERED = "filtered search is not ported yet: ROADMAP A2 (serving shell: filtered and candidate search)"
_SERVING_SHELL = "is not ported yet: ROADMAP A2 (serving shell: filtered and candidate search)"
_FUSION = "is not ported yet: ROADMAP A3 (eval and fusion)"


@dataclass(frozen=True)
class _CorpusState:
    """Everything search reads that depends on the corpus, as ONE object, so
    a corpus update is an atomic reference swap."""

    store: EmbeddingStore  # capacity-padded (row-aligned with the device arrays); unpadded in ann mode
    n_real: int  # rows before padding
    corpus_img: object  # [N, D] corpus dtype, int8 / packed int4 / int32 sign words, or (codes, codebooks); None in ann mode
    corpus_txt: object
    corpus_img_scale: Optional[torch.Tensor]  # per-row scales [N, 1] (int8 / int4 / pq), else None
    corpus_txt_scale: Optional[torch.Tensor]
    ivf: Optional[IVFIndex]  # the packed IVF index in ann mode, else None
    top_k: int  # requested k clamped to the real row count
    nprobe: int  # ann probe width clamped to the (possibly rebuilt) nlist


class CLIPRetrieval:
    """Text- and image-query retrieval over a precomputed :class:`EmbeddingStore`."""

    def __init__(
        self,
        model: CLIP,
        tokenizer: CLIPTokenizer,
        store: EmbeddingStore,
        *,
        device,
        top_k: int = 100,
        corpus_dtype: torch.dtype = torch.float32,
        use_fused_encoder: bool = True,
        quantize: Optional[str] = None,
        quantize_corpus=False,
        ann: Optional[str] = None,
        ann_nlist: Optional[int] = None,
        ann_nprobe: int = 8,
        ann_capacity_factor: float = 1.5,
        ann_index_path: Optional[str] = None,
        ann_max_batch_lookups: float = 1e7,
        capacity_multiple: int = 1,
        rerank: bool = False,
        rerank_factor: int = 4,
        truncate_dim: int = 0,
        rotate=False,
        rotate_seed: int = 0,
        pq_m: int = 0,
        pq_aniso_t: float = 0.0,
        **options,
    ):
        for name, value in options.items():
            if name not in _NOT_PORTED:
                raise TypeError(f"unexpected argument {name!r}")
            if value not in (None, False, 0, 0.0):
                raise NotImplementedError(
                    f"CLIPRetrieval({name}=...) is not ported yet: ROADMAP {_NOT_PORTED[name]}"
                )
        if quantize is not None and not use_fused_encoder:
            raise ValueError("quantize requires use_fused_encoder=True")
        if tokenizer.vocab_size > model.arch.vocab_size:
            # an id past the embedding table would raise (CPU) or trip a
            # device assert (CUDA) at the first query
            raise ValueError(
                f"tokenizer vocab {tokenizer.vocab_size} exceeds the model's {model.arch.vocab_size}"
            )
        # corpus packing: False = exact (bf16/f32), "int8" (True), "int4"
        # (nibble-packed), "pq" (product-quantization codes + per-row
        # scales), "binary" (sign sketches, candidates only)
        if quantize_corpus is True:
            quantize_corpus = "int8"
        if quantize_corpus not in (False, None, "int8", "int4", "pq", "binary"):
            raise ValueError(
                f"unknown quantize_corpus mode {quantize_corpus!r} "
                "(expected False, True/'int8', 'int4', 'pq', or 'binary')"
            )
        self.pq_m = int(pq_m)  # PQ subspaces (0 = dim / 8)
        self.pq_aniso_t = float(pq_aniso_t)  # score-aware PQ threshold (0 = off)
        if self.pq_aniso_t and quantize_corpus != "pq":
            raise ValueError("pq_aniso_t requires quantize_corpus='pq'")
        if self.pq_aniso_t and ann is not None:
            raise ValueError("pq_aniso_t does not compose with ann")
        if self.pq_aniso_t and rotate == "opq":
            raise ValueError(
                "pq_aniso_t and rotate='opq' train conflicting objectives "
                "(score-aware vs reconstruction) — pick one"
            )
        self.quantize_corpus = quantize_corpus or False
        if self.quantize_corpus == "binary":
            # Hamming proxy scores are candidate generation only: the host
            # exact rerank is mandatory
            if not rerank:
                raise ValueError(
                    "quantize_corpus='binary' serves Hamming proxy scores — "
                    "set rerank=True (host exact rescoring) to use it"
                )
            if ann is not None:
                raise ValueError("quantize_corpus='binary' does not compose with ann")

        # Matryoshka serving: the corpus stages as its first truncate_dim
        # coordinates, prefix-re-normalized on the host; queries truncate the
        # same way before the scan. 0 = off.
        if truncate_dim < 0:
            raise ValueError(f"truncate_dim must be >= 0, got {truncate_dim}")
        if truncate_dim and truncate_dim > store.dim:
            raise ValueError(f"truncate_dim {truncate_dim} exceeds the store width {store.dim}")
        if truncate_dim and ann is not None:
            # the IVF cache's config check does not record the prefix width
            raise ValueError("truncate_dim does not compose with ann")
        self.truncate_dim = int(truncate_dim)

        # Rotated quantization (packed corpora only): one orthonormal R
        # rotates corpus rows on the host and queries before the scan; the
        # host f32 store stays unrotated for the rerank.
        rotate_mode = rotate if isinstance(rotate, str) else ("random" if rotate else None)
        if rotate_mode not in (None, "random", "opq"):
            raise ValueError(f"unknown rotate mode {rotate!r} (expected bool, 'random' or 'opq')")
        self.rotate = rotate_mode is not None
        self.rotate_mode = rotate_mode
        self._rot_np = self._rot = None
        if self.rotate:
            if not quantize_corpus:
                raise ValueError(
                    "rotate requires a packed corpus mode (quantize_corpus="
                    "'int8'|'int4'|'pq'|'binary') — it only changes "
                    "quantization rounding, exact scans gain nothing"
                )
            if ann is not None:
                raise ValueError("rotate does not compose with ann")
            dim = int(truncate_dim) or store.dim
            if rotate_mode == "opq":
                # learned once at construction: the rotation minimizing PQ
                # reconstruction error on this corpus (both towers)
                if quantize_corpus != "pq":
                    raise ValueError(
                        "rotate='opq' learns a PQ-reconstruction rotation — "
                        "it requires quantize_corpus='pq' (use rotate=True "
                        "for the random rotation on int8/int4/binary)"
                    )
                rows = np.concatenate(
                    [np.asarray(store.image, np.float32), np.asarray(store.text, np.float32)], axis=0
                )
                if truncate_dim:
                    rows = prefix_normalize_host(rows, int(truncate_dim))
                self._rot_np = train_opq_rotation(rows, m=self.pq_m or max(1, dim // 8), seed=rotate_seed)
            else:
                self._rot_np = random_rotation(dim, rotate_seed)

        # ann="ivf": probe IVF clusters instead of scanning the whole corpus;
        # composes with exact, int8, int4 and pq lists
        if ann not in (None, "ivf"):
            raise ValueError(f"unknown ann mode {ann!r} (expected None or 'ivf')")
        # host rerank: over-fetch rerank_factor * k candidates, rescore them
        # exactly against the f32 host store, re-sort
        if rerank_factor < 1:
            raise ValueError(f"rerank_factor must be >= 1, got {rerank_factor}")
        self.rerank = bool(rerank)
        self.rerank_factor = int(rerank_factor)
        self.ann = ann
        self.ann_nprobe = ann_nprobe
        self._ann_nlist = ann_nlist
        self._ann_capacity_factor = ann_capacity_factor
        # IVF-PQ probe budget: a batch of B queries walks B * nprobe * cap * M
        # LUT entries; searches above the budget raise (<= 0 disables)
        self.ann_max_batch_lookups = float(ann_max_batch_lookups or 0)
        # disk cache of the built IVF index, consulted once at construction
        # (fingerprint + config checks); live updates rebuild in memory only
        if ann_index_path and not str(ann_index_path).endswith(".npz"):
            ann_index_path = str(ann_index_path) + ".npz"
        self.ann_index_path = ann_index_path
        self._index_cache_armed = ann_index_path is not None

        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.tokenizer = tokenizer
        self._requested_top_k = top_k
        self.corpus_dtype = corpus_dtype
        self.capacity_multiple = max(1, int(capacity_multiple))
        self.use_fused_encoder = use_fused_encoder
        self.quantize = quantize
        self._text_plan = (
            make_text_plan(self.model, dtype=model.dtype, quantize=quantize) if use_fused_encoder else None
        )
        self._encode_image = None  # built at the first image query
        self._update_lock = threading.Lock()
        self._install_corpus(store)
        if self._rot_np is not None:
            self._rot = torch.as_tensor(self._rot_np, device=self.device)

    # -- corpus state ----------------------------------------------------------

    def _to_device(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=self.device, dtype=dtype)

    def _install_corpus(self, store: EmbeddingStore) -> None:
        """Build the corpus device state and swap it in atomically."""
        if len(store) == 0:
            raise ValueError("empty corpus")
        n_real = len(store)
        top_k = min(self._requested_top_k, n_real)
        if self.ann == "ivf":
            nlist = self._ann_nlist or max(1, int(np.sqrt(n_real)))
            index = self._load_or_build_index(store, nlist)
            if self.ann_nprobe < 1:
                raise ValueError(f"ann_nprobe must be >= 1, got {self.ann_nprobe}")
            # clamp rather than raise: a corpus-shrinking update can rebuild
            # with a smaller derived nlist (nprobe == nlist is an exact probe)
            self._corpus = _CorpusState(
                store=store, n_real=n_real, corpus_img=None, corpus_txt=None,
                corpus_img_scale=None, corpus_txt_scale=None, ivf=index,
                top_k=top_k, nprobe=min(self.ann_nprobe, index.nlist),
            )
            return
        # pad rows (zero vectors, score 0, sentinel uuids) round the device
        # arrays up to the capacity bucket
        padded = store.padded(self.capacity_multiple)
        src_img, src_txt = padded.image, padded.text
        if self.truncate_dim:
            # the device only sees the prefix; the full f32 store stays on
            # the host for the rerank. Zero pad rows stay zero.
            src_img = prefix_normalize_host(src_img, self.truncate_dim)
            src_txt = prefix_normalize_host(src_txt, self.truncate_dim)
        if self._rot_np is not None:
            # rotation preserves norms, so zero pad rows stay zero
            src_img = np.asarray(src_img, np.float32) @ self._rot_np
            src_txt = np.asarray(src_txt, np.float32) @ self._rot_np
        cimg_s = ctxt_s = None
        if self.quantize_corpus == "binary":
            # sign words packed on the host (uint32 bits held as int32)
            cimg = self._to_device(pack_sign_bits_host(src_img).view(np.int32))
            ctxt = self._to_device(pack_sign_bits_host(src_txt).view(np.int32))
        elif self.quantize_corpus == "pq":
            # per-tower codebooks train on the staged rows (after truncate /
            # rotate); codes + per-row norms upload, the small codebooks ride
            # with them. Zero pad rows pack to scale 0 (score exactly 0).
            src_img = np.asarray(src_img, np.float32)
            src_txt = np.asarray(src_txt, np.float32)
            m = self.pq_m or max(1, src_img.shape[1] // 8)
            if self.pq_aniso_t:
                cb_i = train_pq_codebooks_anisotropic(src_img, m=m, t=self.pq_aniso_t)
                cb_t = train_pq_codebooks_anisotropic(src_txt, m=m, t=self.pq_aniso_t)
            else:
                cb_i = train_pq_codebooks(src_img, m=m)
                cb_t = train_pq_codebooks(src_txt, m=m)
            codes_i, si = pack_pq_host(src_img, cb_i, aniso_t=self.pq_aniso_t)
            codes_t, st = pack_pq_host(src_txt, cb_t, aniso_t=self.pq_aniso_t)
            cimg = (self._to_device(codes_i), self._to_device(cb_i))
            ctxt = (self._to_device(codes_t), self._to_device(cb_t))
            cimg_s, ctxt_s = self._to_device(si), self._to_device(st)
        elif self.quantize_corpus:
            # int8 / int4 quantized on the host: the f32 corpus never stages
            # on the device
            quantizer = quantize_corpus_host_q4 if self.quantize_corpus == "int4" else quantize_corpus_host
            qi, si = quantizer(src_img)
            qt, st = quantizer(src_txt)
            cimg, cimg_s, ctxt, ctxt_s = (self._to_device(a) for a in (qi, si, qt, st))
        elif self.truncate_dim:
            cimg = self._to_device(src_img, self.corpus_dtype)
            ctxt = self._to_device(src_txt, self.corpus_dtype)
        else:
            cimg, ctxt = padded.device_arrays(self.corpus_dtype, self.device)
        self._corpus = _CorpusState(
            store=padded, n_real=n_real, corpus_img=cimg, corpus_txt=ctxt,
            corpus_img_scale=cimg_s, corpus_txt_scale=ctxt_s, ivf=None,
            top_k=top_k, nprobe=0,
        )

    def _load_or_build_index(self, store: EmbeddingStore, nlist: int) -> IVFIndex:
        use_cache, self._index_cache_armed = self._index_cache_armed, False
        fp = corpus_fingerprint(store.image, store.text) if use_cache else None
        quantize = self.quantize_corpus or None  # 'int8' | 'int4' | 'pq' | None
        if use_cache and os.path.exists(self.ann_index_path):
            try:
                index = load_ivf_index(self.ann_index_path, device=self.device, expected_fingerprint=fp)
            except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
                index = None  # truncated / corrupt / another corpus: rebuild
            if index is not None and quantize is None and index.packed_img.dtype == torch.float32:
                # exact lists: the file holds f32 (numpy has no bf16); the
                # cast to a bf16 corpus is what a rebuild would pack
                index = dataclasses.replace(
                    index, packed_img=index.packed_img.to(self.corpus_dtype),
                    packed_txt=index.packed_txt.to(self.corpus_dtype),
                )
            # the CONFIG must match the cached file too, or retuned
            # nlist / capacity / dtype flags would be silently ignored
            expected_cap = max(
                _CAP_SUBLANE,
                -(-int(np.ceil(self._ann_capacity_factor * len(store) / nlist)) // _CAP_SUBLANE) * _CAP_SUBLANE,
            )
            expected_m = (self.pq_m or max(1, store.dim // 8)) if quantize == "pq" else None
            if (
                index is not None
                and index.mode == (quantize or "exact")
                and index.nlist == nlist
                and index.cap >= expected_cap
                and (quantize != "pq" or index.packed_img.shape[-1] == expected_m)
                and (quantize is not None or index.packed_img.dtype == self.corpus_dtype)
            ):
                return index
        index = build_ivf_index(
            store.image, store.text, nlist,
            capacity_factor=self._ann_capacity_factor, dtype=self.corpus_dtype,
            quantize=quantize, pq_m=self.pq_m or None, device=self.device,
        )
        if use_cache:
            save_ivf_index(self.ann_index_path, index, fingerprint=fp)
        return index

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
        """Queries -> L2-normalized [B, D] embeddings on the device."""
        ids = torch.as_tensor(self._tokenize(queries), dtype=torch.long).to(self.device)
        if self.use_fused_encoder:
            q = encode_text_fast(self.model.arch, self._text_plan, ids)
        else:
            q = self.model.encode_text(ids)
        return l2_normalize(q)

    def search_batch(self, queries: Sequence[str], alpha=0.5, top_k: Optional[int] = None):
        """Batched search: ``(values [Q, k_fetch], rows [Q, k_fetch])`` device
        tensors; ``k_fetch >= k`` over-fetches past capacity-pad rows (and
        for the rerank). With ``rerank=True`` a third element carries the
        f32 [Q, D] query embeddings and the order is NOT reranked — use
        :meth:`results_from_topk`-based :meth:`retrieval_batch` for results."""
        return self._search_state(self._corpus, queries, alpha, top_k)

    def _search_state(self, c: _CorpusState, queries: Sequence[str], alpha, top_k: Optional[int]):
        return self._search_state_emb(c, self.encode_queries(queries), alpha, top_k)

    @torch.no_grad()
    def _search_state_emb(self, c: _CorpusState, q_emb, alpha, top_k: Optional[int]):
        k = min(top_k or c.top_k, c.n_real)
        q = torch.as_tensor(q_emb, dtype=torch.float32, device=self.device)
        self._check_pq_probe_cost(c, q.shape[0])
        vals, idx = self._score(c, q, alpha, self._k_fetch(c, k))
        # the rerank rescores in the original space: unrotated, full width
        return (vals, idx, q) if self.rerank else (vals, idx)

    def _score(self, c: _CorpusState, q: torch.Tensor, alpha, k: int, nprobe: Optional[int] = None):
        """Blend + top-k of f32 query embeddings against the corpus state."""
        if self.truncate_dim:
            q = prefix_normalize(q, self.truncate_dim)
        if self._rot is not None:
            q = q.float() @ self._rot
        if self.ann == "ivf":
            return ivf_search(q, c.ivf, k=k, nprobe=nprobe or c.nprobe, alpha=alpha)
        if self.quantize_corpus == "binary":
            dim = self.truncate_dim or c.store.dim
            return hamming_topk(q.float(), c.corpus_img, c.corpus_txt, dim=dim, k=k, alpha=alpha)
        if self.quantize_corpus == "pq":
            q = q.to(self.model.dtype).contiguous()
            (codes_i, cb_i), (codes_t, cb_t) = c.corpus_img, c.corpus_txt
            return pq_similarity_topk(
                q, codes_i, c.corpus_img_scale, codes_t, c.corpus_txt_scale, cb_i, cb_t, k=k, alpha=alpha
            )
        if self.quantize_corpus:
            q = q.to(self.model.dtype).contiguous()
            fn = fused_similarity_topk_q4 if self.quantize_corpus == "int4" else fused_similarity_topk_q8
            return fn(q, c.corpus_img, c.corpus_img_scale, c.corpus_txt, c.corpus_txt_scale, k=k, alpha=alpha)
        q = q.to(c.corpus_img.dtype).contiguous()
        return fused_similarity_topk(q, c.corpus_img, c.corpus_txt, k=k, alpha=alpha)

    def _k_fetch(self, c: _CorpusState, k: int) -> int:
        """Pad rows score exactly 0 and could displace negative-scoring real
        matches: over-fetch by the bucket's maximum pad count; the rerank
        over-fetches ``rerank_factor`` x (IVF has no pad rows)."""
        if self.rerank:
            k = k * self.rerank_factor
        if self.ann == "ivf":
            return min(k, c.n_real) if self.rerank else k
        return min(k + self.capacity_multiple - 1, len(c.store))

    def _check_pq_probe_cost(self, c: _CorpusState, batch: int) -> None:
        """Refuse IVF-PQ searches whose LUT-walk lookup count exceeds
        ``ann_max_batch_lookups`` (batch x nprobe x cap x M)."""
        if self.ann != "ivf" or self.quantize_corpus != "pq" or self.ann_max_batch_lookups <= 0:
            return
        cap, m = int(c.ivf.packed_img.shape[1]), int(c.ivf.packed_img.shape[2])
        est = float(batch) * c.nprobe * cap * m
        if est > self.ann_max_batch_lookups:
            raise ValueError(
                f"IVF-PQ wide-probe batch refused: ~{est:.2g} ADC lookups "
                f"(batch={batch} x nprobe={c.nprobe} x cap={cap} x m={m}) exceed the "
                f"ann_max_batch_lookups budget of {self.ann_max_batch_lookups:.2g}. "
                "Options: lower ann_nprobe or the batch size, use "
                "quantize_corpus='int8'/'int4' with ann='ivf' (dense probes), or "
                "raise ann_max_batch_lookups (<= 0 disables the check)."
            )

    # -- IVF calibration ----------------------------------------------------------

    @torch.no_grad()
    def calibrate_nprobe(
        self,
        queries: Optional[Sequence[str]] = None,
        q_emb=None,
        *,
        target_recall: float = 0.95,
        k: Optional[int] = None,
        alpha: float = 0.5,
        sample: int = 256,
        seed: int = 0,
        apply: bool = True,
    ) -> dict:
        """Tune the IVF probe width to a recall target (ann mode only): the
        smallest of 1, 2, 4, ... nlist whose recall@k against the exact f32
        host ranking meets ``target_recall``, on ``q_emb``, the encoded
        ``queries`` or ``sample`` corpus text rows. ``apply=True`` swaps the
        width into the live corpus state. Returns the
        :func:`retrieval.ann.calibrate_nprobe` report."""
        if self.ann != "ivf":
            raise ValueError("calibrate_nprobe needs ann='ivf'")
        from .ann import calibrate_nprobe as _calibrate

        c = self._corpus
        if q_emb is None:
            if queries is not None:
                q_emb = self.encode_queries(queries).float().cpu().numpy()
            else:
                rng = np.random.default_rng(seed)
                rows = rng.choice(c.n_real, size=min(sample, c.n_real), replace=False)
                q_emb = np.asarray(c.store.text[rows], np.float32)
        k = min(k or c.top_k, c.n_real)

        def search_fn(q, kk, nprobe):
            qt = torch.as_tensor(np.asarray(q, np.float32), device=self.device)
            return self._score(c, qt, alpha, kk, nprobe=nprobe)

        result = _calibrate(
            c.ivf, q_emb, c.store.image[: c.n_real], c.store.text[: c.n_real],
            k=k, alpha=alpha, target_recall=target_recall, search_fn=search_fn,
        )
        if apply and result["nprobe"] != c.nprobe:
            self.ann_nprobe = result["nprobe"]  # future rebuilds inherit it
            self._corpus = dataclasses.replace(c, nprobe=min(result["nprobe"], c.ivf.nlist))
        return result

    # -- host-side exact rerank ---------------------------------------------------

    def _rerank_host(self, c: _CorpusState, q: torch.Tensor, idx: torch.Tensor, alpha) -> Tuple[np.ndarray, np.ndarray]:
        """Exactly rescore the fetched candidates against the f32 host store
        (``idx`` -1 = ann sentinel). Pad rows score 0 and are filtered by
        uuid downstream, as on the device path."""
        if torch.is_tensor(alpha):
            alpha = alpha.detach().cpu().numpy()
        return rerank_scores_host(
            q.float().cpu().numpy(), c.store.image, c.store.text, idx.cpu().numpy(),
            np.asarray(alpha, np.float32),
        )

    def _finish_results(self, c: _CorpusState, out, alpha, k: int) -> List[List[Dict]]:
        """Search output -> per-query result dicts (rerank-aware)."""
        if self.rerank:
            _, idx, q = out
            vals, idx = self._rerank_host(c, q, idx, alpha)
        else:
            vals, idx = out
            vals, idx = vals.float().cpu().numpy(), idx.cpu().numpy()
        return self.results_from_topk(vals, idx, _state=c, top_k=k)

    # -- filtered search (ROADMAP A2) ---------------------------------------------

    def search_filtered_batch(self, *args, **kwargs):
        raise NotImplementedError(_FILTERED)

    def retrieval_filtered_batch(self, *args, **kwargs):
        raise NotImplementedError(_FILTERED)

    def retrieval_filtered(self, *args, **kwargs):
        raise NotImplementedError(_FILTERED)

    def retrieval_filtered_embeddings_batch(self, *args, **kwargs):
        raise NotImplementedError(_FILTERED)

    # -- candidate, pipelined and fused search (ROADMAP A2, A3) --------------------

    def retrieval_candidates_batch(self, *args, **kwargs):
        raise NotImplementedError(f"CLIPRetrieval.retrieval_candidates_batch {_SERVING_SHELL}")

    def retrieval_batches(self, *args, **kwargs):
        raise NotImplementedError(f"CLIPRetrieval.retrieval_batches {_SERVING_SHELL}")

    def search_batches_pipelined(self, *args, **kwargs):
        raise NotImplementedError(f"CLIPRetrieval.search_batches_pipelined {_SERVING_SHELL}")

    def retrieval_fused(self, *args, **kwargs):
        raise NotImplementedError(f"CLIPRetrieval.retrieval_fused {_FUSION}")

    def retrieval_fused_batch(self, *args, **kwargs):
        raise NotImplementedError(f"CLIPRetrieval.retrieval_fused_batch {_FUSION}")

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

    def _ranked(self, c: _CorpusState, out, alpha, top_k: Optional[int]) -> List[List[Dict]]:
        return self._finish_results(c, out, alpha, min(top_k or c.top_k, c.n_real))

    def retrieval_batch(self, queries: Sequence[str], alpha=0.5, top_k: Optional[int] = None) -> List[List[Dict]]:
        """Batched search -> one ``[{"uuid", "score"}]`` list per query.
        ``alpha`` may be a scalar or one blend per query."""
        c = self._corpus  # one snapshot: search and uuid mapping stay aligned
        return self._ranked(c, self._search_state(c, queries, alpha, top_k), alpha, top_k)

    def retrieval(self, query: str, alpha: float = 0.5, top_k: Optional[int] = None) -> List[Dict]:
        """Single-query search -> ``[{"uuid", "score"}]`` sorted descending."""
        return self.retrieval_batch([query], alpha=alpha, top_k=top_k)[0]

    # -- image / embedding queries ----------------------------------------------
    # An image query rides the vision tower and is blended against both corpus
    # towers by the same scan (the blend is linear in the query embedding);
    # alpha = 1.0 is pure image-to-image search.

    def _build_image_encoder(self):
        if not self.use_fused_encoder:
            return self.model.encode_image
        plan = make_vision_plan(self.model, dtype=self.model.dtype, quantize=self.quantize)
        return lambda px: encode_image_fast(self.model.arch, plan, px)

    @torch.no_grad()
    def encode_images(self, pixels) -> torch.Tensor:
        """Preprocessed pixels [B, S, S, 3] -> L2-normalized [B, D] f32 on the
        device, through the same encoder tier as text queries. The vision
        plan is built at the first image query, so text-only serving pays
        nothing for it."""
        if self._encode_image is None:
            self._encode_image = self._build_image_encoder()
        px = torch.as_tensor(pixels, dtype=torch.float32, device=self.device)
        return l2_normalize(self._encode_image(px))

    def preprocess_images(self, images) -> np.ndarray:
        """Decode + preprocess a heterogeneous batch to [B, S, S, 3]: PIL
        images, encoded bytes, file paths, HWC uint8 arrays, or float32
        [S, S, 3] arrays that are already preprocessed (passed through)."""
        size = self.model.arch.image_resolution
        out = []
        for im in images:
            if isinstance(im, np.ndarray) and im.dtype == np.float32 and im.shape == (size, size, 3):
                out.append(im)
            else:
                out.append(preprocess_pil(im, size=size))
        return np.stack(out)

    def encode_documents(self, images: Sequence, texts: Sequence[str]):
        """Raw documents -> store-ready rows ``(image_emb, text_emb)``,
        L2-normalized f32 ``[n, D]`` numpy, for :meth:`add_documents`. The
        text rows encode the documents' target text through the query tower.
        (The JAX version pads the batch to a power of two to bound its jit
        compiles; the eager port needs no padding.)"""
        if len(images) != len(texts):
            raise ValueError(f"{len(images)} images vs {len(texts)} texts")
        if len(images) == 0:
            raise ValueError("no documents")
        img = self.encode_images(self.preprocess_images(images)).cpu().numpy()
        txt = self.encode_queries(list(texts)).cpu().numpy()
        return img, txt

    def search_embeddings_batch(self, q_emb, alpha=0.5, top_k: Optional[int] = None):
        """Batched search from L2-normalized [Q, D] query embeddings (same
        over-fetch semantics as :meth:`search_batch`)."""
        return self._search_state_emb(self._corpus, q_emb, alpha, top_k)

    def retrieval_embeddings_batch(self, q_emb, alpha=0.5, top_k: Optional[int] = None) -> List[List[Dict]]:
        """Embedding-direct search -> one ``[{"uuid", "score"}]`` list per query."""
        c = self._corpus
        return self._ranked(c, self._search_state_emb(c, q_emb, alpha, top_k), alpha, top_k)

    def retrieval_image_batch(self, images: Sequence, alpha=0.5, top_k: Optional[int] = None) -> List[List[Dict]]:
        """Visual search: a batch of images (as :meth:`preprocess_images`
        takes them) -> ranked corpus matches each."""
        return self.retrieval_embeddings_batch(
            self.encode_images(self.preprocess_images(images)), alpha=alpha, top_k=top_k
        )
