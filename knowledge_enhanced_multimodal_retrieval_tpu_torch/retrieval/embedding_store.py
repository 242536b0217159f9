"""Precomputed corpus embedding store.

The port's copy of ``EmbeddingStore`` from
``knowledge_enhanced_multimodal_retrieval_tpu/retrieval/embedding_store.py``:
L2-normalized image/text tower embeddings + row-aligned uuids, persisted as
one ``.npz`` in the same format (a store written by either package loads in
the other; either can memory-map it). :meth:`EmbeddingStore.device_arrays` replaces the JAX upload;
:func:`build_embedding_store` precomputes a store with the port's towers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data.datasets import DataPipeline
from ..eval.evaluator import encode_dataset
from ..models.clip import CLIP


def host_tensor(a) -> torch.Tensor:
    """A host array as a CPU tensor, copied only where torch cannot share it:
    a read-only array (a memory-mapped store) is copied, since torch would
    warn and hand out a writable view of it."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


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
    def load(cls, path: str, mmap: bool = False) -> "EmbeddingStore":
        """Load a saved store. ``mmap=True`` memory-maps the tower arrays
        (read-only) instead of reading them into RAM: the packed-corpus
        modes only read the f32 rows (host quantization streams them once,
        the host rerank gathers candidate rows), so the OS pages in what is
        touched. Needs an uncompressed ``.npz`` (``save`` writes one) and
        keeps the file open for the store's lifetime."""
        if mmap:
            import struct
            import zipfile

            # np.load(mmap_mode=...) ignores mmap for zip members, so map each
            # member at its offset in the archive: the local zip header (30
            # bytes + name + extra), the .npy header, then the array bytes
            with zipfile.ZipFile(path) as zf:

                def as_mmap(name):
                    info = zf.getinfo(name + ".npy")
                    if info.compress_type != zipfile.ZIP_STORED:
                        raise ValueError(
                            f"{path!r} member {name} is compressed; mmap needs "
                            "an uncompressed .npz (np.savez, not savez_compressed)"
                        )
                    with zf.open(name + ".npy") as f:
                        version = np.lib.format.read_magic(f)
                        read_header = {
                            (1, 0): np.lib.format.read_array_header_1_0,
                            (2, 0): np.lib.format.read_array_header_2_0,
                        }.get(version)
                        if read_header is None:
                            raise ValueError(f"unsupported .npy version {version}")
                        shape, fortran, dtype = read_header(f)
                        npy_header = f.tell()
                    with open(path, "rb") as raw:
                        raw.seek(info.header_offset + 26)
                        name_len, extra_len = struct.unpack("<HH", raw.read(4))
                    data_off = info.header_offset + 30 + name_len + extra_len + npy_header
                    return np.memmap(
                        path, dtype=dtype, mode="r", shape=shape,
                        offset=data_off, order="F" if fortran else "C",
                    )

                image = as_mmap("image")
                text = as_mmap("text")
                with zf.open("uuids.npy") as f:
                    uuids = [str(u) for u in np.lib.format.read_array(f, allow_pickle=True)]
            return cls(image=image, text=text, uuids=uuids)
        with np.load(path, allow_pickle=True) as data:
            return cls(image=data["image"], text=data["text"], uuids=[str(u) for u in data["uuids"]])

    # -- device placement ----------------------------------------------------

    def device_arrays(self, dtype: torch.dtype, device=None, mesh=None, axis: str = "data"):
        """Both towers as ``dtype`` tensors on ``device``, or row-sharded
        over ``axis`` of ``mesh`` (``parallel.sharding.RowShards``; pad to the
        shard multiple first with :meth:`padded`)."""
        if mesh is not None:
            from ..parallel.sharding import shard_rows

            return tuple(shard_rows(host_tensor(a).to(dtype=dtype), mesh, axis) for a in (self.image, self.text))
        img = host_tensor(self.image).to(device=device, dtype=dtype)
        txt = host_tensor(self.text).to(device=device, dtype=dtype)
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


def build_embedding_store(
    model: CLIP,
    pipeline: DataPipeline,
    batch_size: int = 256,
    use_fast: bool = False,
    quantize: Optional[str] = None,
    rt=None,
) -> EmbeddingStore:
    """Precompute corpus embeddings on the model's device, or over the mesh
    runtime ``rt`` (each data shard on its device, ``eval.encode_dataset``).

    The ``text`` tower stores *target_text* embeddings (the corpus documents
    the serving engine scores T2T against). ``use_fast``/``quantize`` route
    through the fused / int8 towers (``models.fast_encode``)."""
    encoded = encode_dataset(model, pipeline, batch_size, use_fast=use_fast, quantize=quantize, rt=rt)
    return EmbeddingStore(image=encoded.image, text=encoded.target, uuids=encoded.uuids)
