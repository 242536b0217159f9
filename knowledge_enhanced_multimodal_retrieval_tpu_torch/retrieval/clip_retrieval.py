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
rerank. Also the serving shell's entry points: filtered search (a uuid
allow / deny row mask, plain masked top-k), candidate scoring on the host,
the pipelined batch streams, warmup, and corpus replacement and snapshots;
and learned-fusion serving (a trained head rescores the scan's candidates).
Every tensor lives on the explicit ``device``; CUDA runs the hand-written
kernels, the CPU their plain versions. The search runs eagerly (no
per-bucket compiled program).

Over a :class:`parallel.mesh.MeshRuntime` (``rt``) the retriever has the JAX
package's two sharded modes. ``shard_corpus`` (capacity): the corpus rows
(or the IVF clusters) shard over the mesh's data axis, each shard is scanned
on its own device (the tier's kernel once a shard on the card) and only the
``[Q, k]`` winners merge; the rows pad to ``capacity_multiple x num_data``.
``shard_queries`` (throughput): the query batch pads to a multiple of the
data axis and splits over it; each slice is encoded and scanned on its own
device against a replica of the corpus, and the results concatenate in
order. A device that repeats in the mesh holds one copy, and a shard on the
device that holds the staged corpus is a row view of it.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import os
import threading
import zipfile
from collections import deque
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.preprocess import preprocess_pil
from ..data.tokenizer import DEFAULT_BUCKETS as _WARMUP_BUCKETS
from ..data.tokenizer import CLIPTokenizer, trim_to_bucket
from ..models.clip import CLIP, l2_normalize
from ..models.fast_encode import encode_image_fast, encode_text_fast, make_text_plan, make_vision_plan
from ..ops.binary_sketch import hamming_topk, pack_sign_bits_host, sharded_hamming_topk
from ..ops.pq import (
    masked_pq_similarity_topk,
    pack_pq_host,
    pq_similarity_topk,
    sharded_masked_pq_similarity_topk,
    sharded_pq_similarity_topk,
    train_opq_rotation,
    train_pq_codebooks,
    train_pq_codebooks_anisotropic,
)
from ..ops.dispatch import to_device
from ..ops.similarity import (
    alpha_column,
    fused_similarity_topk,
    fused_similarity_topk_q4,
    fused_similarity_topk_q8,
    masked_similarity_topk,
    masked_similarity_topk_q4,
    masked_similarity_topk_q8,
    normalize_mask,
    prefix_normalize,
    prefix_normalize_host,
    quantize_corpus_host,
    quantize_corpus_host_q4,
    random_rotation,
    rerank_scores_host,
    sharded_masked_similarity_topk,
    sharded_similarity_topk,
    sharded_similarity_topk_q4,
    sharded_similarity_topk_q8,
)
from ..parallel.mesh import MeshRuntime, canonical_device
from ..parallel.sharding import gather_shard_outputs, replicate, shard_rows
from ..utils.profiling import count, span, spanned
from .ann import _SUBLANE as _CAP_SUBLANE
from .ann import (
    IVFIndex,
    build_ivf_index,
    corpus_fingerprint,
    ivf_search,
    load_ivf_index,
    save_ivf_index,
    shard_ivf_index,
    sharded_ivf_search,
)
from .embedding_store import EmbeddingStore, host_tensor


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
    ann_spill_fraction: float = 0.0  # IVF rows packed outside their best cluster; 0.0 without an index
    ivf_shards: object = None  # shard_corpus in ann mode: the index cut by cluster over the mesh
    replicas: Optional[dict] = None  # shard_queries: this state on each other query device


class _Fetch:
    """What a finish reads of one search batch, on its way to the host.

    Each CUDA tensor of ``items`` is copied into a pinned host tensor with
    ``non_blocking`` as the batch is dispatched, and an event is recorded
    after the copies on each device's current stream: queuing them never
    waits for the card, and :meth:`wait` waits for this batch alone, not for
    the batches queued after it. CPU tensors and other values pass as they
    are. The device tensors stay referenced until the events have passed."""

    __slots__ = ("items", "host", "events")

    def __init__(self, items: Sequence):
        self.items = tuple(items)
        self.host, streams = [], {}
        for x in self.items:
            if torch.is_tensor(x) and x.is_cuda:
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                streams.setdefault(x.device, torch.cuda.current_stream(x.device))
                x = h
            self.host.append(x)
        self.events = []
        for stream in streams.values():
            event = torch.cuda.Event()
            event.record(stream)
            self.events.append(event)

    def wait(self) -> tuple:
        """The items on the host, tensors as NumPy arrays. Counts
        ``retrieval.fetch_ready`` if the batch had finished on the card
        before the call, else ``retrieval.fetch_waited``."""
        ready = all(e.query() for e in self.events)
        count("retrieval.fetch_ready" if ready else "retrieval.fetch_waited")
        for e in self.events:
            e.synchronize()
        return tuple(x.detach().numpy() if torch.is_tensor(x) else x for x in self.host)


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
        rt: Optional[MeshRuntime] = None,
        shard_corpus: bool = False,
        shard_queries: bool = False,
    ):
        self.rt = rt
        # shard_corpus scales capacity (rows split over the mesh's data
        # axis, queries replicated); shard_queries scales throughput (query
        # batches split, corpus and weights replicated). Without a mesh both
        # are off, as in the JAX package.
        self.shard_corpus = bool(shard_corpus) and rt is not None
        self.shard_queries = bool(shard_queries) and rt is not None
        if self.shard_queries and self.shard_corpus:
            raise ValueError(
                "shard_queries and shard_corpus both shard over the mesh's "
                "data axis — pick one (capacity vs throughput scaling)"
            )
        if (self.shard_corpus or self.shard_queries) and getattr(rt, "dcn_axis", None):
            raise ValueError(
                "serving shards over ONE intra-slice data axis; a multi-slice "
                "(dcn) mesh is a training layout — serve each slice with its "
                "own single-slice MeshRuntime"
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

        self.device = canonical_device(device)
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
        # shard_queries: the towers (and their plans) on each other device
        # the query slices run on; the first is this retriever's own
        self._replicas = {}
        for dev in self._query_devices():
            m = copy.deepcopy(self.model).to(dev)
            plan = make_text_plan(m, dtype=model.dtype, quantize=quantize) if use_fused_encoder else None
            self._replicas[dev] = (m, plan)
        self._update_lock = threading.Lock()
        self._install_corpus(store)
        if self._rot_np is not None:
            self._rot = torch.as_tensor(self._rot_np, device=self.device)

    # -- corpus state ----------------------------------------------------------

    def _to_device(self, a, dtype=None):
        """A host array staged for the scan: on the retriever's device, or
        row-sharded over the mesh's data axis under ``shard_corpus``."""
        if self.shard_corpus:
            return shard_rows(host_tensor(a).to(dtype=dtype), self.rt.mesh, self.rt.data_axis)
        return host_tensor(a).to(device=self.device, dtype=dtype)

    def _pad_multiple(self) -> int:
        """Device rows round up to this (capacity bucket x mesh shards)."""
        return self.capacity_multiple * (self.rt.num_data if self.shard_corpus else 1)

    def _query_devices(self) -> List[torch.device]:
        """Under ``shard_queries``, the distinct devices other than the
        retriever's own that query slices run on."""
        if not self.shard_queries:
            return []
        devs = dict.fromkeys(d for _, d in self.rt.mesh.axis_shards(self.rt.data_axis))
        return [d for d in devs if d != self.device]

    def _replicate(self, state: "_CorpusState") -> "_CorpusState":
        """Under ``shard_queries``, the corpus state on every query device."""
        devs = self._query_devices()
        if not devs:
            return state

        def copies(t):  # {device: t there} over the mesh
            if t is None:
                return dict.fromkeys(devs)
            if isinstance(t, tuple):
                parts = [copies(x) for x in t]
                return {dev: tuple(p[dev] for p in parts) for dev in devs}
            return replicate(t, self.rt.mesh)

        fields = ("corpus_img", "corpus_txt", "corpus_img_scale", "corpus_txt_scale")
        placed = {f: copies(getattr(state, f)) for f in fields}
        reps = {dev: dataclasses.replace(state, ivf=None if state.ivf is None else state.ivf.to(dev),
                                         **{f: placed[f][dev] for f in fields}) for dev in devs}
        return dataclasses.replace(state, replicas=reps)

    def _state_on(self, c: "_CorpusState", dev: torch.device) -> "_CorpusState":
        return c if dev == self.device or not c.replicas else c.replicas[dev]

    @spanned("retrieval.install_corpus")
    def _install_corpus(self, store: EmbeddingStore) -> None:
        """Build the corpus device state and swap it in atomically."""
        if len(store) == 0:
            raise ValueError("empty corpus")
        n_real = len(store)
        top_k = min(self._requested_top_k, n_real)
        if self.ann == "ivf":
            nlist = self._ann_nlist or max(1, int(np.sqrt(n_real)))
            if self.shard_corpus:
                # clusters shard over the mesh: nlist snaps to the nearest
                # workable multiple of the axis size (<= corpus rows)
                n_shards = self.rt.num_data
                nlist = min(-(-nlist // n_shards) * n_shards, (n_real // n_shards) * n_shards)
                if nlist < n_shards:
                    raise ValueError(f"corpus of {n_real} rows cannot shard {n_shards} ways in ann mode")
            index = self._load_or_build_index(store, nlist)
            if self.ann_nprobe < 1:
                raise ValueError(f"ann_nprobe must be >= 1, got {self.ann_nprobe}")
            shards = None
            if self.shard_corpus:
                shards = shard_ivf_index(index, self.rt.mesh, self.rt.data_axis)
                if any(li.packed_rows.device != index.packed_rows.device for _, li in shards.shards):
                    index = index.to("cpu")  # the shards hold the device copies
            # clamp rather than raise: a corpus-shrinking update can rebuild
            # with a smaller derived nlist (nprobe == nlist is an exact probe)
            self._corpus = self._replicate(_CorpusState(
                store=store, n_real=n_real, corpus_img=None, corpus_txt=None,
                corpus_img_scale=None, corpus_txt_scale=None, ivf=index,
                top_k=top_k, nprobe=min(self.ann_nprobe, index.nlist),
                ann_spill_fraction=index.spill_fraction, ivf_shards=shards,
            ))
            return
        # pad rows (zero vectors, score 0, sentinel uuids) round the device
        # arrays up to the capacity bucket (and the mesh's shard count)
        padded = store.padded(self._pad_multiple())
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
            # the codebooks replicate (KB-sized): they stay on this device
            cimg = (self._to_device(codes_i), host_tensor(cb_i).to(self.device))
            ctxt = (self._to_device(codes_t), host_tensor(cb_t).to(self.device))
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
            mesh = self.rt.mesh if self.shard_corpus else None
            cimg, ctxt = padded.device_arrays(self.corpus_dtype, self.device, mesh=mesh,
                                              axis=self.rt.data_axis if mesh else "data")
        self._corpus = self._replicate(_CorpusState(
            store=padded, n_real=n_real, corpus_img=cimg, corpus_txt=ctxt,
            corpus_img_scale=cimg_s, corpus_txt_scale=ctxt_s, ivf=None,
            top_k=top_k, nprobe=0,
        ))

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

    @property
    def corpus_img(self):
        """The image tower's device corpus as the scan reads it (None under IVF)."""
        return self._corpus.corpus_img

    @property
    def corpus_txt(self):
        return self._corpus.corpus_txt

    @property
    def corpus_img_scale(self) -> Optional[torch.Tensor]:
        """Per-row scales [N, 1] of an int8 / int4 / pq corpus, else None."""
        return self._corpus.corpus_img_scale

    @property
    def corpus_txt_scale(self) -> Optional[torch.Tensor]:
        return self._corpus.corpus_txt_scale

    @property
    def ann_spill_fraction(self) -> float:
        """Share of rows the IVF index packed outside their best cluster."""
        return self._corpus.ann_spill_fraction

    def set_store(self, store: EmbeddingStore) -> None:
        """Replace the corpus wholesale (rebuilds the device state, then swaps)."""
        with self._update_lock:
            self._install_corpus(store)

    def add_documents(self, image: np.ndarray, text: np.ndarray, uuids: Sequence[str]) -> None:
        """Append documents (L2-normalized [n, D] tower embeddings + uuids)."""
        with self._update_lock:
            self._install_corpus(self._corpus_real_store().with_added(image, text, uuids))

    def remove_documents(self, uuids: Sequence[str]) -> None:
        """Retire documents by uuid (unknown uuids raise KeyError)."""
        with self._update_lock:
            self._install_corpus(self._corpus_real_store().with_removed(uuids))

    def save_store(self, path: str) -> int:
        """Persist the current corpus (live-ingested documents included,
        capacity pads left out) to ``path`` atomically; returns the row
        count. Serialized against updates, so the snapshot is one corpus
        version; a memory-mapped store writes its live rows."""
        with self._update_lock:
            store = self._corpus_real_store()
        store.save(path)
        return len(store)

    def _corpus_real_store(self) -> EmbeddingStore:
        c = self._corpus
        if len(c.store) == c.n_real:
            return c.store
        return EmbeddingStore(
            image=c.store.image[: c.n_real], text=c.store.text[: c.n_real], uuids=c.store.uuids[: c.n_real]
        )

    # -- core ----------------------------------------------------------------

    @spanned("retrieval.tokenize")
    def _tokenize(self, queries: Sequence[str]) -> np.ndarray:
        ids = self.tokenizer(list(queries), context_length=self.model.arch.context_length)
        return trim_to_bucket(ids)

    def seq_bucket(self, query: str) -> int:
        """The seq bucket this query encodes at."""
        return int(self._tokenize([query]).shape[1])

    def encode_queries(self, queries: Sequence[str]) -> torch.Tensor:
        """Queries -> L2-normalized [B, D] embeddings on the device."""
        return self._encode_ids(self._tokenize(queries))

    @spanned("retrieval.encode")
    @torch.no_grad()
    def _encode_ids(self, ids, device=None) -> torch.Tensor:
        """Token ids -> L2-normalized embeddings on ``device`` (default the
        retriever's; under ``shard_queries`` another query device's replica).
        Host ids reach a card through pinned memory, so the copy is queued
        without waiting for the card."""
        device = self.device if device is None else device
        model, plan = self._replicas.get(device, (self.model, self._text_plan))
        ids = to_device(torch.as_tensor(ids, dtype=torch.long), device)
        if self.use_fused_encoder:
            q = encode_text_fast(model.arch, plan, ids)
        else:
            q = model.encode_text(ids)
        return l2_normalize(q)

    def _qdp(self, body, *arrays) -> tuple:
        """Query data parallelism (``shard_queries``): pad the leading query
        axis of ``arrays`` to a multiple of the mesh's data ways by repeating
        the first row, run ``body(device, *slices) -> tuple`` for each of this
        process's slices on its device, and concatenate each output in slice
        order (across processes too), the pad cut off."""
        n = self.rt.num_data
        nq = arrays[0].shape[0]
        qs = -(-nq // n)
        pad = qs * n - nq
        if pad:
            arrays = [torch.cat([a, a[:1].expand(pad, *a.shape[1:])]) for a in arrays]
        outs = [body(dev, *(a[g * qs:(g + 1) * qs] for a in arrays))
                for g, dev in self.rt.mesh.axis_shards(self.rt.data_axis)]
        merged = []
        for parts in zip(*outs):
            every = gather_shard_outputs(parts, self.rt.mesh)  # [n, qs, ...]
            merged.append(every.reshape(n * qs, *every.shape[2:])[:nq])
        return tuple(merged)

    def search_batch(self, queries: Sequence[str], alpha=0.5, top_k: Optional[int] = None):
        """Batched search: ``(values [Q, k_fetch], rows [Q, k_fetch])`` device
        tensors; ``k_fetch >= k`` over-fetches past capacity-pad rows (and
        for the rerank). With ``rerank=True`` a third element carries the
        f32 [Q, D] query embeddings and the order is NOT reranked — use
        :meth:`results_from_topk`-based :meth:`retrieval_batch` for results."""
        return self._search_state(self._corpus, queries, alpha, top_k)

    @torch.no_grad()
    def _search_state(self, c: _CorpusState, queries: Sequence[str], alpha, top_k: Optional[int]):
        if not self.shard_queries:
            return self._search_state_emb(c, self.encode_queries(queries), alpha, top_k)
        # each query slice is tokenized here, then encoded and scanned on its device
        ids = torch.as_tensor(self._tokenize(queries), dtype=torch.long)
        k = self._k_fetch(c, min(top_k or c.top_k, c.n_real))
        self._check_pq_probe_cost(c, ids.shape[0])

        def body(dev, ids_s, a_s):
            q = self._encode_ids(ids_s, dev)
            out = self._score(self._state_on(c, dev), q, a_s, k)
            return out + (q,) if self.rerank else out

        return self._qdp(body, ids, alpha_column(alpha, ids.shape[0], self.device))

    @torch.no_grad()
    def _search_state_emb(self, c: _CorpusState, q_emb, alpha, top_k: Optional[int]):
        k = min(top_k or c.top_k, c.n_real)
        q = torch.as_tensor(q_emb, dtype=torch.float32, device=self.device)
        self._check_pq_probe_cost(c, q.shape[0])
        if self.shard_queries:
            def body(dev, q_s, a_s):
                return self._score(self._state_on(c, dev), q_s.to(dev), a_s, self._k_fetch(c, k))

            vals, idx = self._qdp(body, q, alpha_column(alpha, q.shape[0], self.device))
        else:
            vals, idx = self._score(c, q, alpha, self._k_fetch(c, k))
        # the rerank rescores in the original space: unrotated, full width
        return (vals, idx, q) if self.rerank else (vals, idx)

    @spanned("retrieval.scan")
    def _score(self, c: _CorpusState, q: torch.Tensor, alpha, k: int, nprobe: Optional[int] = None):
        """Blend + top-k of f32 query embeddings against the corpus state."""
        if self.truncate_dim:
            q = prefix_normalize(q, self.truncate_dim)
        if self._rot is not None:
            q = q.float() @ self._rot.to(q.device)
        # shard_corpus: the tier's sharded scan over the mesh's data axis
        mesh = dict(mesh=self.rt.mesh, axis=self.rt.data_axis) if self.shard_corpus else None
        if self.ann == "ivf":
            if mesh:
                return sharded_ivf_search(q, c.ivf_shards, k=k, nprobe=nprobe or c.nprobe, alpha=alpha, **mesh)
            return ivf_search(q, c.ivf, k=k, nprobe=nprobe or c.nprobe, alpha=alpha)
        if self.quantize_corpus == "binary":
            dim = self.truncate_dim or c.store.dim
            fn = functools.partial(sharded_hamming_topk, **mesh) if mesh else hamming_topk
            return fn(q.float(), c.corpus_img, c.corpus_txt, dim=dim, k=k, alpha=alpha)
        if self.quantize_corpus == "pq":
            q = q.to(self.model.dtype).contiguous()
            (codes_i, cb_i), (codes_t, cb_t) = c.corpus_img, c.corpus_txt
            fn = functools.partial(sharded_pq_similarity_topk, **mesh) if mesh else pq_similarity_topk
            return fn(q, codes_i, c.corpus_img_scale, codes_t, c.corpus_txt_scale, cb_i, cb_t, k=k, alpha=alpha)
        if self.quantize_corpus:
            q = q.to(self.model.dtype).contiguous()
            if mesh:
                fn = sharded_similarity_topk_q4 if self.quantize_corpus == "int4" else sharded_similarity_topk_q8
                fn = functools.partial(fn, **mesh)
            else:
                fn = fused_similarity_topk_q4 if self.quantize_corpus == "int4" else fused_similarity_topk_q8
            return fn(q, c.corpus_img, c.corpus_img_scale, c.corpus_txt, c.corpus_txt_scale, k=k, alpha=alpha)
        q = q.to(c.corpus_img.dtype).contiguous()
        fn = functools.partial(sharded_similarity_topk, **mesh) if mesh else fused_similarity_topk
        return fn(q, c.corpus_img, c.corpus_txt, k=k, alpha=alpha)

    def _score_masked(self, c: _CorpusState, q: torch.Tensor, alpha, mask, k: int):
        """Blend + top-k restricted to ``mask``-eligible rows (the JAX
        retriever's ``_score_fn_masked``, in its order: truncate, rotate, the
        binary refusal, pq, int4 / int8, exact). Dead slots carry row -1."""
        if self.truncate_dim:
            q = prefix_normalize(q, self.truncate_dim)
        if self._rot is not None:
            q = q.float() @ self._rot.to(q.device)
        if self.quantize_corpus == "binary":
            raise ValueError(
                "filtered search is not supported over a binary-sketch "
                "corpus — use candidate scoring (retrieval_candidates_batch)"
            )
        mask = normalize_mask(mask, q.shape[0], len(c.store), device=q.device)
        mesh = dict(mesh=self.rt.mesh, axis=self.rt.data_axis) if self.shard_corpus else None
        if self.quantize_corpus == "pq":
            q = q.to(self.model.dtype)
            (codes_i, cb_i), (codes_t, cb_t) = c.corpus_img, c.corpus_txt
            fn = functools.partial(sharded_masked_pq_similarity_topk, **mesh) if mesh else masked_pq_similarity_topk
            return fn(q, codes_i, c.corpus_img_scale, codes_t, c.corpus_txt_scale, cb_i, cb_t, mask, k=k, alpha=alpha)
        if self.quantize_corpus:
            q = q.to(self.model.dtype)
            args = (c.corpus_img, c.corpus_img_scale, c.corpus_txt, c.corpus_txt_scale)
            if mesh:
                mode = "q4" if self.quantize_corpus == "int4" else "q8"
                return sharded_masked_similarity_topk(q, args, mask, k=k, alpha=alpha, mode=mode, **mesh)
            fn = masked_similarity_topk_q4 if self.quantize_corpus == "int4" else masked_similarity_topk_q8
            return fn(q, *args, mask, k=k, alpha=alpha)
        q = q.to(c.corpus_img.dtype)
        if mesh:
            return sharded_masked_similarity_topk(q, (c.corpus_img, c.corpus_txt), mask, k=k, alpha=alpha,
                                                  mode="exact", **mesh)
        return masked_similarity_topk(q, c.corpus_img, c.corpus_txt, mask, k=k, alpha=alpha)

    def _k_fetch(self, c: _CorpusState, k: int) -> int:
        """Pad rows score exactly 0 and could displace negative-scoring real
        matches: over-fetch by the bucket's maximum pad count; the rerank
        over-fetches ``rerank_factor`` x (IVF has no pad rows)."""
        if self.rerank:
            k = k * self.rerank_factor
        if self.ann == "ivf":
            return min(k, c.n_real) if self.rerank else k
        return min(k + self._pad_multiple() - 1, len(c.store))

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

    # -- warmup ---------------------------------------------------------------------

    @torch.no_grad()
    def warmup(
        self,
        batch_sizes: Sequence[int],
        *,
        alpha: float = 0.5,
        top_k: Optional[int] = None,
        seq_buckets: Optional[Sequence[int]] = None,
        image: bool = False,
    ) -> int:
        """Run the search once per (batch size, seq bucket), and the image
        search once per batch size with ``image=True``, before serving;
        returns the count of searches run (the JAX retriever's count for the
        same arguments). Nothing compiles here: the first searches load the
        kernel library, fill the tensor-map caches and size the allocator's
        pools, which a daemon should pay before it takes connections."""
        c = self._corpus
        ctx = self.model.arch.context_length
        buckets = sorted({b for b in (seq_buckets or _WARMUP_BUCKETS) if b <= ctx}) or [ctx]
        count = 0
        for b in batch_sizes:
            if b < 1:
                raise ValueError(f"warmup batch size must be >= 1, got {b}")
            for s in buckets:
                q = self._encode_ids(np.ones((int(b), int(s)), np.int64))
                self._search_state_emb(c, q, alpha, top_k)
                count += 1
            if image:
                size = self.model.arch.image_resolution
                pixels = np.zeros((int(b), size, size, 3), np.float32)
                self._search_state_emb(c, self.encode_images(pixels), alpha, top_k)
                count += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return count

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

    def _rerank_host(self, c: _CorpusState, fetch: _Fetch) -> Tuple[np.ndarray, np.ndarray]:
        """Exactly rescore the fetched candidates ``(rows, f32 queries,
        alpha)`` against the f32 host store (row -1 = ann sentinel). Pad rows
        score 0 and are filtered by uuid downstream, as on the device path."""
        with span("retrieval.fetch"):
            idx, q, alpha = fetch.wait()
        return rerank_scores_host(q, c.store.image, c.store.text, idx, np.asarray(alpha, np.float32))

    def _fetch(self, out, alpha) -> _Fetch:
        """What :meth:`_finish_results` reads of a search output, its copies
        to the host queued now: the winners, or under the rerank the rows,
        the f32 queries and alpha."""
        if self.rerank:
            _, idx, q = out
            return _Fetch((idx, q.float(), alpha))
        vals, idx = out
        return _Fetch((vals.float(), idx))

    def _finish_results(self, c: _CorpusState, out, alpha, k: int) -> List[List[Dict]]:
        """Search output, or its :meth:`_fetch` queued at dispatch -> per-query
        result dicts (rerank-aware). Waits for that batch alone."""
        fetch = out if isinstance(out, _Fetch) else self._fetch(out, alpha)
        if self.rerank:
            vals, idx = self._rerank_host(c, fetch)
        else:
            with span("retrieval.fetch"):
                vals, idx = fetch.wait()
        return self.results_from_topk(vals, idx, _state=c, top_k=k)

    # -- filtered search -------------------------------------------------------------
    # A bool row mask over the padded store restricts the scan; changing the
    # filter changes an operand, nothing else. Pad rows are always masked, so
    # the filtered path needs no pad over-fetch.

    def _mask_from_uuids(
        self, c: _CorpusState, allow_uuids: Optional[Iterable[str]], deny_uuids: Optional[Iterable[str]]
    ) -> np.ndarray:
        """Bool row mask over the padded store (pads always False). Unknown
        uuids in either list are ignored: a filter is a predicate over the
        corpus, not a membership assertion."""
        if allow_uuids is None and deny_uuids is None:
            raise ValueError("filtered search needs allow_uuids and/or deny_uuids")
        uuids = c.store.uuids
        if allow_uuids is not None:
            allowed = set(allow_uuids)
            mask = np.fromiter((u in allowed for u in uuids), bool, len(uuids))
        else:
            mask = np.fromiter((not u.startswith("__pad_") for u in uuids), bool, len(uuids))
        if deny_uuids is not None:
            denied = set(deny_uuids)
            if denied:
                mask &= np.fromiter((u not in denied for u in uuids), bool, len(uuids))
        return mask

    def _k_fetch_masked(self, c: _CorpusState, k: int) -> int:
        # pads are masked out (never displace winners); only the rerank over-fetches
        return min(k * self.rerank_factor, len(c.store)) if self.rerank else k

    def search_filtered_batch(
        self,
        queries: Sequence[str],
        allow_uuids: Optional[Iterable[str]] = None,
        deny_uuids: Optional[Iterable[str]] = None,
        alpha=0.5,
        top_k: Optional[int] = None,
    ):
        """Batched search restricted by uuid allow / deny lists (raw winners,
        as :meth:`search_batch` returns them); slots past the eligible rows
        carry row -1. Needs an exact corpus scan: with ``ann='ivf'`` use
        :meth:`retrieval_candidates_batch`."""
        return self._search_filtered_state(self._corpus, queries, allow_uuids, deny_uuids, alpha, top_k)

    def _search_filtered_state(self, c: _CorpusState, queries, allow_uuids, deny_uuids, alpha, top_k):
        if self.ann == "ivf":
            raise ValueError(
                "filtered search needs an exact corpus scan (ann='ivf' probes "
                "clusters); use retrieval_candidates_batch for allow-lists in ann mode"
            )
        mask = self._mask_from_uuids(c, allow_uuids, deny_uuids)
        if not self.shard_queries:
            return self._filtered_emb(c, self.encode_queries(queries), mask, alpha, top_k)
        ids = torch.as_tensor(self._tokenize(queries), dtype=torch.long)
        k = self._k_fetch_masked(c, min(top_k or c.top_k, c.n_real))

        def body(dev, ids_s, a_s):
            q = self._encode_ids(ids_s, dev)
            out = self._score_masked(self._state_on(c, dev), q, a_s, mask, k)
            return out + (q,) if self.rerank else out

        with torch.no_grad():
            return self._qdp(body, ids, alpha_column(alpha, ids.shape[0], self.device))

    @torch.no_grad()
    def _filtered_emb(self, c: _CorpusState, q_emb, mask, alpha, top_k: Optional[int]):
        k = self._k_fetch_masked(c, min(top_k or c.top_k, c.n_real))
        q = torch.as_tensor(q_emb, dtype=torch.float32, device=self.device)
        if self.shard_queries:
            # the row mask is one filter for the batch: it replicates
            def body(dev, q_s, a_s):
                return self._score_masked(self._state_on(c, dev), q_s.to(dev), a_s, mask, k)

            vals, idx = self._qdp(body, q, alpha_column(alpha, q.shape[0], self.device))
        else:
            vals, idx = self._score_masked(c, q, alpha, mask, k)
        return (vals, idx, q) if self.rerank else (vals, idx)

    def retrieval_filtered_batch(
        self,
        queries: Sequence[str],
        allow_uuids: Optional[Iterable[str]] = None,
        deny_uuids: Optional[Iterable[str]] = None,
        alpha=0.5,
        top_k: Optional[int] = None,
    ) -> List[List[Dict]]:
        """Filtered batched search -> one ``[{"uuid", "score"}]`` list per
        query; only rows that pass the filter appear, so a query with fewer
        eligible rows than ``top_k`` gets a shorter list."""
        c = self._corpus
        out = self._search_filtered_state(c, queries, allow_uuids, deny_uuids, alpha, top_k)
        return self._ranked(c, out, alpha, top_k)

    def retrieval_filtered(
        self,
        query: str,
        allow_uuids: Optional[Iterable[str]] = None,
        deny_uuids: Optional[Iterable[str]] = None,
        alpha: float = 0.5,
        top_k: Optional[int] = None,
    ) -> List[Dict]:
        """Single-query filtered search -> ``[{"uuid", "score"}]`` descending."""
        return self.retrieval_filtered_batch([query], allow_uuids, deny_uuids, alpha=alpha, top_k=top_k)[0]

    def retrieval_filtered_embeddings_batch(
        self,
        q_emb,
        allow_uuids: Optional[Iterable[str]] = None,
        deny_uuids: Optional[Iterable[str]] = None,
        alpha=0.5,
        top_k: Optional[int] = None,
    ) -> List[List[Dict]]:
        """Filtered search from L2-normalized [Q, D] query embeddings."""
        c = self._corpus
        if self.ann == "ivf":
            raise ValueError("filtered search needs an exact corpus scan (ann='ivf' probes clusters)")
        mask = self._mask_from_uuids(c, allow_uuids, deny_uuids)
        return self._ranked(c, self._filtered_emb(c, q_emb, mask, alpha, top_k), alpha, top_k)

    # -- candidate scoring and pipelined batches -----------------------------------

    def retrieval_candidates_batch(
        self, queries: Sequence[str], candidates: Sequence[Sequence[str]], alpha=0.5, top_k: Optional[int] = None
    ) -> List[List[Dict]]:
        """Exact scoring restricted to per-query candidate uuid lists (e.g.
        each query's Text2SPARQL hits): the queries encode on the device in
        one batch, the scoring runs on the f32 host store
        (:func:`ops.similarity.rerank_scores_host`), so it works in every
        corpus mode, IVF included. Unknown uuids are ignored."""
        if len(queries) != len(candidates):
            raise ValueError(f"{len(queries)} queries vs {len(candidates)} candidate lists")
        c = self._corpus
        k = min(top_k or c.top_k, c.n_real)
        row_of = {u: i for i, u in enumerate(c.store.uuids[: c.n_real])}
        width = max(1, max((len(cd) for cd in candidates), default=1))
        idx = np.full((len(queries), width), -1, np.int64)
        for qi, cand in enumerate(candidates):
            rows = [row_of[u] for u in dict.fromkeys(cand) if u in row_of]
            idx[qi, : len(rows)] = rows
        q = self.encode_queries(queries)
        vals, idx = self._rerank_host(c, _Fetch((idx, q.float(), alpha)))
        return self.results_from_topk(vals, idx, _state=c, top_k=k)

    def search_batches_pipelined(
        self, query_batches: Iterable[Sequence[str]], alpha=0.5, top_k: Optional[int] = None, depth: int = 4
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Stream batches with up to ``depth`` searches queued on the device:
        batch i's winners are fetched while later batches are tokenized and
        launched. Yields ``(values, rows)`` numpy pairs in order.

        A dispatch never waits for the card: the query ids and alpha reach
        it through pinned memory, and the winners' copies to the host are
        queued behind an event as the batch is launched. A finish waits on
        that event, for its own batch only."""
        pending: deque = deque()
        for queries in query_batches:
            vals, idx = self.search_batch(queries, alpha=alpha, top_k=top_k)[:2]
            pending.append(_Fetch((vals.float(), idx)))
            if len(pending) >= max(1, depth):
                yield pending.popleft().wait()
        while pending:
            yield pending.popleft().wait()

    def retrieval_batches(
        self, query_batches: Iterable[Sequence[str]], alpha=0.5, top_k: Optional[int] = None, depth: int = 4
    ) -> Iterator[List[List[Dict]]]:
        """Streamed :meth:`retrieval_batch`: pipelined as
        :meth:`search_batches_pipelined`, one result list per query, in
        order. Each batch maps through the corpus snapshot its search ran
        on, so results stay uuid-correct under concurrent updates. The spans
        of a batch carry its ordinal in the stream.

        The same contract: a dispatch never waits for the card, and a finish
        waits for its own batch only (the event recorded after its copies
        to the host, queued at dispatch: :meth:`_fetch`)."""
        pending: deque = deque()

        def dispatch(i, queries):
            with span("retrieval.dispatch", id=i):
                c = self._corpus
                return i, c, self._fetch(self._search_state(c, queries, alpha, top_k), alpha)

        def finish(item):
            i, c, out = item
            with span("retrieval.finish", id=i):
                return self._ranked(c, out, alpha, top_k)

        for i, queries in enumerate(query_batches):
            pending.append(dispatch(i, queries))
            if len(pending) >= max(1, depth):
                yield finish(pending.popleft())
        while pending:
            yield finish(pending.popleft())

    # -- learned-fusion serving -------------------------------------------------------
    # Stage 1 fetches the blended top-(factor * k) candidates through the
    # corpus tier's scan (B2 / B2-q4 / B5 / IVF on the card); stage 2 rescores
    # them with a trained head over their exact f32 store rows, so the head
    # sees exact embeddings whatever the tier packed.

    @torch.no_grad()
    def retrieval_fused_batch(
        self,
        queries: Sequence[str],
        fusion,
        fusion_params,
        alpha=0.5,
        top_k: Optional[int] = None,
        factor: int = 4,
    ) -> List[List[Dict]]:
        """Two-tier learned-fusion search -> ``[{"uuid", "score"}]`` lists.

        ``fusion``: a :class:`models.fusion_heads.FusionModel`;
        ``fusion_params``: its trained head module (on any device; the
        candidates go to it). ``alpha`` steers only the stage-1 fetch of
        ``min(factor * top_k, rows)`` candidates; the head gives the final
        scores, so with ``factor * k`` at the corpus size the result is the
        head's exact full-corpus ranking.
        """
        c = self._corpus
        k = min(top_k or c.top_k, c.n_real)
        fetch = min(factor * k, c.n_real)
        q = self.encode_queries(queries)
        idx = self._search_state_emb(c, q, alpha, fetch)[1].cpu().numpy()
        safe = np.maximum(idx, 0)
        head_dev = next(fusion_params.parameters()).device
        img = torch.as_tensor(np.asarray(c.store.image[safe], np.float32), device=head_dev)  # [Q, R, D] exact rows
        tgt = torch.as_tensor(np.asarray(c.store.text[safe], np.float32), device=head_dev)
        scores = fusion.candidate_scores(fusion_params, q.float().to(head_dev), img, tgt).float().cpu().numpy()
        # sentinels (-1) and pad rows (>= n_real, zero vectors) never rank
        scores = np.where((idx >= 0) & (idx < c.n_real), scores, -np.inf)
        order = np.argsort(-scores, axis=1, kind="stable")
        return self.results_from_topk(
            np.take_along_axis(scores, order, 1), np.take_along_axis(idx, order, 1), _state=c, top_k=k
        )

    def retrieval_fused(self, query: str, fusion, fusion_params, alpha: float = 0.5,
                        top_k: Optional[int] = None, factor: int = 4) -> List[Dict]:
        """Single-query learned-fusion search."""
        return self.retrieval_fused_batch([query], fusion, fusion_params, alpha=alpha, top_k=top_k,
                                          factor=factor)[0]

    # -- reference-parity API --------------------------------------------------

    @spanned("retrieval.map")
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

    def retrieval_image(self, image, alpha: float = 0.5, top_k: Optional[int] = None) -> List[Dict]:
        """Single-image visual search -> ``[{"uuid", "score"}]`` descending."""
        return self.retrieval_image_batch([image], alpha=alpha, top_k=top_k)[0]
