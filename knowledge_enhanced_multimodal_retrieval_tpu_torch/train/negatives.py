"""Hard-negative mining for contrastive fine-tuning.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/train/negatives.py``,
the offline half of the mined-negatives loop:

- :func:`mine_hard_negatives`: for each anchor row the top-k highest-scoring
  *other* candidate rows (self excluded), on the device in blocks of
  anchors: one f32 product, the self mask, a top-k ordered as ``lax.top_k``
  orders (value descending, then row ascending: a stable sort, since
  ``torch.topk`` on a CUDA tensor promises no order among ties). The JAX
  version pads the last block to a static shape for ``jit``; eager blocks
  need no padding.
- :func:`save_negatives` / :func:`load_negatives`: the ``[N, M]`` table as
  one ``.npz`` in the JAX package's format, with the uuid sequence it was
  mined on and its digest, so a table is never applied to another (or a
  reordered) dataset.

The online half is ``train.losses`` (``neg_text_features``) and
``train.trainer`` (``TrainConfig.hard_negatives`` / ``hard_negatives_k``).
"""

from __future__ import annotations

import hashlib
import json
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["mine_hard_negatives", "save_negatives", "load_negatives", "uuid_digest"]


def mine_hard_negatives(anchors, candidates, k: int, block: int = 2048, device=None) -> np.ndarray:
    """[N, D] anchors x [N, D] candidates -> [N, k] int32 rows, hardest first.

    Row i holds the k candidate rows other than i (anchor i's gold pairing)
    with the highest inner product against anchor i. Runs on ``device``
    (default: the anchors' own if a tensor, else the CPU)."""
    as_t = lambda x: x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    a, c = as_t(anchors), as_t(candidates)
    device = torch.device(device) if device is not None else a.device
    a, c = a.to(device, torch.float32), c.to(device, torch.float32)
    n = a.shape[0]
    if c.shape[0] != n:
        raise ValueError(f"anchors/candidates must be row-aligned, got {n} vs {c.shape[0]}")
    if not 0 < k < n:
        raise ValueError(f"need 0 < k < n_examples, got k={k}, n={n}")
    block = min(block, n)
    out = torch.empty(n, k, dtype=torch.int32, device=device)
    cols = torch.arange(n, device=device)
    for start in range(0, n, block):
        stop = min(start + block, n)
        scores = a[start:stop] @ c.T
        scores = scores.masked_fill(cols[None, :] == cols[start:stop, None], float("-inf"))
        # a stable descending sort: equal scores keep the lower row first
        out[start:stop] = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :k].to(torch.int32)
    return out.cpu().numpy()


def uuid_digest(uuids: Sequence[str]) -> str:
    """Order-sensitive digest of the dataset's uuid sequence."""
    h = hashlib.sha256()
    for u in uuids:
        h.update(u.encode("utf-8"))
        h.update(b"\x00")
    return h.hexdigest()


def save_negatives(path: str, idx: np.ndarray, uuids: Sequence[str], meta: dict | None = None) -> None:
    """A mined [N, M] table with the row-aligned uuids it was mined on."""
    idx = np.asarray(idx, np.int32)
    if idx.ndim != 2 or idx.shape[0] != len(uuids):
        raise ValueError(f"idx must be [N, M] aligned with uuids, got {idx.shape} vs {len(uuids)}")
    payload = {"digest": uuid_digest(uuids), "n": int(idx.shape[0]), **(meta or {})}
    np.savez(path, idx=idx, uuids=np.asarray(list(uuids), dtype=np.str_), __meta__=json.dumps(payload))


def load_negatives(path: str) -> Tuple[np.ndarray, List[str]]:
    """A mined table: ([N, M] int32 rows, the row-aligned uuids)."""
    with np.load(path, allow_pickle=False) as z:
        idx = np.asarray(z["idx"], np.int32)
        uuids = [str(u) for u in z["uuids"]]
    if idx.shape[0] != len(uuids):
        raise ValueError(f"corrupt negatives file {path}: {idx.shape} vs {len(uuids)} uuids")
    return idx, uuids
