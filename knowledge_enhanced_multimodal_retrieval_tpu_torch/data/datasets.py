"""Datasets and host-side batching.

The port's copy of ``knowledge_enhanced_multimodal_retrieval_tpu/data/datasets.py``
for the precompute path: sources yield ``{image, query_text, target_text,
uuid}`` records (the HF dataset's schema); :class:`DataPipeline`
word-truncates the texts, preprocesses the images on a thread pool with a
zero-image fallback, BPE-tokenizes both texts and yields dense numpy
batches. Epoch order is a seeded permutation, the same one the JAX
package draws.
"""

from __future__ import annotations

import concurrent.futures as cf
import random
from dataclasses import dataclass
from typing import Any, Iterator, List, Mapping, Optional, Protocol, Sequence

import numpy as np

from .preprocess import safe_preprocess
from .tokenizer import CLIPTokenizer, truncate_words


class ExampleSource(Protocol):
    def __len__(self) -> int: ...

    def __getitem__(self, idx: int) -> Mapping[str, Any]: ...


class InMemoryDataset:
    """List-backed source for tests, synthetic corpora and small evals."""

    def __init__(self, records: Sequence[Mapping[str, Any]]):
        self.records = list(records)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, idx: int) -> Mapping[str, Any]:
        return self.records[idx]


class HFDatasetAdapter:
    """Adapter over a HuggingFace dataset split with the reference schema
    (``image`` PIL, ``query_text``, ``target_text``, ``uuid``)."""

    def __init__(self, hf_split):
        self.ds = hf_split

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, idx: int) -> Mapping[str, Any]:
        s = self.ds[int(idx)]
        return {"image": s["image"], "query_text": s["query_text"], "target_text": s["target_text"],
                "uuid": s["uuid"]}


def load_hf_source(name: str, split: str) -> HFDatasetAdapter:
    """Load an HF dataset split (reference ``trainer.py:395-398``)."""
    from datasets import load_dataset

    return HFDatasetAdapter(load_dataset(name)[split])


@dataclass
class Batch:
    """One dense host batch (numpy)."""

    images: np.ndarray  # [B, S, S, 3] float32, CLIP-normalized
    query_ids: np.ndarray  # [B, context] int32
    target_ids: np.ndarray  # [B, context] int32
    uuids: List[str]
    decode_ok: np.ndarray  # [B] bool: False where the zero-image fallback fired
    indices: Optional[np.ndarray] = None  # [B] int64 source rows


class DataPipeline:
    """Host batching: decode/preprocess (threaded) + tokenize + stack."""

    def __init__(
        self,
        source: ExampleSource,
        tokenizer: CLIPTokenizer,
        image_size: int = 224,
        context_length: int = 77,
        max_text_words: int = 150,
        num_workers: int = 8,
        preprocess_mode: str = "openai",
    ):
        self.source = source
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.context_length = context_length
        self.max_text_words = max_text_words
        self.num_workers = max(1, num_workers)
        self.preprocess_mode = preprocess_mode  # "openai" | "hf" (data/preprocess.py)

    def __len__(self) -> int:
        return len(self.source)

    def make_batch(self, indices: Sequence[int]) -> Batch:
        records = [self.source[i] for i in indices]
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            results = list(
                pool.map(lambda r: safe_preprocess(r["image"], self.image_size, mode=self.preprocess_mode), records)
            )
        queries = [truncate_words(r["query_text"], self.max_text_words) for r in records]
        targets = [truncate_words(r["target_text"], self.max_text_words) for r in records]
        return Batch(
            images=np.stack([r[0] for r in results]),
            query_ids=self.tokenizer(queries, context_length=self.context_length),
            target_ids=self.tokenizer(targets, context_length=self.context_length),
            uuids=[r["uuid"] for r in records],
            decode_ok=np.array([r[1] for r in results]),
            indices=np.asarray(list(indices), np.int64),
        )

    def negative_target_ids(self, indices: np.ndarray, table: np.ndarray, k: int) -> np.ndarray:
        """[B] batch rows + [N, M] mined table -> [B, k, L] token ids of each
        example's top-k mined negatives' target texts (``train.negatives``),
        each distinct text tokenized once a batch."""
        sel = np.asarray(table)[np.asarray(indices)][:, :k]  # [B, k]
        uniq, inv = np.unique(sel, return_inverse=True)
        texts = [truncate_words(self.source[int(i)]["target_text"], self.max_text_words) for i in uniq]
        toks = self.tokenizer(texts, context_length=self.context_length)
        return np.asarray(toks)[inv].reshape(sel.shape[0], k, -1)

    def epoch_batches(
        self,
        batch_size: int,
        epoch: int = 0,
        shuffle: bool = True,
        seed: int = 42,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
    ) -> Iterator[Batch]:
        """Batches of one epoch, in a permutation fixed by (seed, epoch).

        With ``num_shards`` > 1 (one shard a process, ``DistributedSampler``'s
        semantics) ``batch_size`` stays the global batch and this process
        loads only its contiguous ``batch_size / num_shards`` slice of each
        one; a short tail batch (``drop_last=False``) first repeats its
        leading indices up to a multiple of ``num_shards``, so every shard
        gets an equal, non-empty slice."""
        if batch_size % num_shards:
            raise ValueError(f"batch_size={batch_size} not divisible by num_shards={num_shards}")
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard_index {shard_index} out of range for {num_shards} shards")
        n = len(self.source)
        order = list(range(n))
        if shuffle:
            random.Random(seed * 1_000_003 + epoch).shuffle(order)
        stop = n - (n % batch_size) if drop_last else n
        for start in range(0, stop, batch_size):
            idxs = order[start : start + batch_size]
            if num_shards > 1:
                if len(idxs) % num_shards:
                    target = -(-len(idxs) // num_shards) * num_shards
                    idxs = (idxs * (target // len(idxs) + 1))[:target]
                local_b = len(idxs) // num_shards
                idxs = idxs[shard_index * local_b : (shard_index + 1) * local_b]
            yield self.make_batch(idxs)

    def num_batches(self, batch_size: int, drop_last: bool = True) -> int:
        n = len(self.source)
        return n // batch_size if drop_last else -(-n // batch_size)


def make_synthetic_source(
    n: int,
    image_size: int = 32,
    seed: int = 0,
    vocab_words: Sequence[str] = ("hello", "world", "cat"),
) -> InMemoryDataset:
    """Random image-text-query triplets (no network); the same records as
    the JAX package's for the same arguments."""
    rng = np.random.default_rng(seed)
    records = []
    for i in range(n):
        img = (rng.random((image_size + 8, image_size + 8, 3)) * 255).astype(np.uint8)
        words = [vocab_words[int(rng.integers(len(vocab_words)))] for _ in range(6)]
        records.append(
            {"image": img, "query_text": " ".join(words[:3]), "target_text": " ".join(words),
             "uuid": f"uuid-{i:06d}"}
        )
    return InMemoryDataset(records)
