"""Precomputed corpus embedding store.

The port's copy of ``EmbeddingStore`` from
``knowledge_enhanced_multimodal_retrieval_tpu/retrieval/embedding_store.py``:
L2-normalized image/text tower embeddings + row-aligned uuids, persisted as
one ``.npz`` in the same format (a store written by either package loads in
the other). :meth:`EmbeddingStore.device_arrays` replaces the JAX upload.
Building a store needs the vision tower and waits for its port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch


class DuplicateUUIDError(ValueError):
    """An added document's uuid is already in the store."""


@dataclass
class EmbeddingStore:
    """Corpus embeddings: ``image`` and ``text`` towers + aligned UUIDs."""

    image: np.ndarray  # [N, D] float32, L2-normalized
    text: np.ndarray  # [N, D] float32, L2-normalized
    uuids: List[str]

    def __post_init__(self):
        n = len(self.uuids)
        if self.image.shape[0] != n or self.text.shape[0] != n:
            raise ValueError(
                f"row mismatch: image {self.image.shape[0]}, text {self.text.shape[0]}, uuids {n}"
            )

    def __len__(self) -> int:
        return len(self.uuids)

    @property
    def dim(self) -> int:
        return self.image.shape[1]

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> None:
        """Persist atomically: write a sibling temp file, then rename."""
        import os
        import tempfile

        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f,
                    image=np.asarray(self.image, np.float32),
                    text=np.asarray(self.text, np.float32),
                    uuids=np.array(self.uuids, dtype=object),
                )
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str) -> "EmbeddingStore":
        with np.load(path, allow_pickle=True) as data:
            return cls(image=data["image"], text=data["text"], uuids=[str(u) for u in data["uuids"]])

    # -- device placement ----------------------------------------------------

    def device_arrays(self, dtype: torch.dtype, device):
        """Both towers as ``dtype`` tensors on ``device``."""
        img = torch.as_tensor(np.asarray(self.image, np.float32)).to(device=device, dtype=dtype)
        txt = torch.as_tensor(np.asarray(self.text, np.float32)).to(device=device, dtype=dtype)
        return img.contiguous(), txt.contiguous()

    # -- incremental updates ---------------------------------------------------
    # Updates return a NEW store, so a serving retriever keeps reading the
    # old one until it swaps.

    def with_added(self, image: np.ndarray, text: np.ndarray, uuids: Sequence[str]) -> "EmbeddingStore":
        """New store with rows appended. ``uuids`` must be fresh; rows are
        re-L2-normalized defensively (a no-op for already-normalized input)."""
        image = np.atleast_2d(np.asarray(image, np.float32))
        text = np.atleast_2d(np.asarray(text, np.float32))
        uuids = [str(u) for u in uuids]
        if image.shape != (len(uuids), self.dim) or text.shape != (len(uuids), self.dim):
            raise ValueError(
                f"expected image/text of shape ({len(uuids)}, {self.dim}); "
                f"got {image.shape} / {text.shape}"
            )
        from collections import Counter

        counts = Counter(uuids)
        dup = (counts.keys() & set(self.uuids)) | {u for u, c in counts.items() if c > 1}
        if dup:
            raise DuplicateUUIDError(f"duplicate uuids: {sorted(dup)[:5]}")

        def norm(x):
            n = np.linalg.norm(x, axis=1, keepdims=True)
            if not np.all(n > 0):
                raise ValueError("zero-norm embedding row")
            return x / n

        return EmbeddingStore(
            image=np.concatenate([self.image, norm(image)]),
            text=np.concatenate([self.text, norm(text)]),
            uuids=self.uuids + uuids,
        )

    def with_removed(self, uuids: Sequence[str]) -> "EmbeddingStore":
        """New store without the given rows; unknown uuids raise."""
        drop = {str(u) for u in uuids}
        missing = drop - set(self.uuids)
        if missing:
            raise KeyError(f"unknown uuids: {sorted(missing)[:5]}")
        keep = [i for i, u in enumerate(self.uuids) if u not in drop]
        return EmbeddingStore(
            image=self.image[keep], text=self.text[keep], uuids=[self.uuids[i] for i in keep]
        )

    def padded(self, multiple: int) -> "EmbeddingStore":
        """Zero-pad rows to a multiple (pad rows score 0 and carry a sentinel uuid)."""
        n = len(self)
        pad = (-n) % multiple
        if pad == 0:
            return self
        z = np.zeros((pad, self.dim), np.float32)
        return EmbeddingStore(
            image=np.concatenate([self.image, z]),
            text=np.concatenate([self.text, z]),
            uuids=self.uuids + [f"__pad_{i}" for i in range(pad)],
        )
