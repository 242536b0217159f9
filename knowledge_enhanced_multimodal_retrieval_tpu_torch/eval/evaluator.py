"""Encoding a dataset into normalized embeddings, on one device.

Counterpart of ``EncodedDataset`` / ``encode_dataset`` in
``knowledge_enhanced_multimodal_retrieval_tpu/eval/evaluator.py`` and of
``make_encode_step`` in ``train/trainer.py``. The JAX version shards each
batch over a device mesh and pads the last one to keep jit shapes static;
here one eager loop runs on the model's device, every batch at its own size,
and the rows keep the dataset's order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..data.datasets import DataPipeline
from ..models.clip import CLIP, l2_normalize
from ..models.fast_encode import encode_image_fast, encode_text_fast, make_encode_plans


@dataclass
class EncodedDataset:
    """Normalized embeddings for one split, row-aligned with ``uuids``."""

    image: np.ndarray  # [N, D]
    query: np.ndarray  # [N, D]
    target: np.ndarray  # [N, D]
    uuids: List[str]


def make_encode_step(model: CLIP, plans: Optional[Dict[str, Any]] = None) -> Callable:
    """``(images, query_ids, target_ids) -> (img, query, target)`` L2-normalized
    f32 embeddings. With ``plans`` (:func:`make_encode_plans`) the serving
    encoders run (the ``fast`` / ``int8`` kernels); without, the module
    towers (``flax`` mode)."""
    arch = model.arch

    @torch.no_grad()
    def step(images: torch.Tensor, query_ids: torch.Tensor, target_ids: torch.Tensor):
        if plans is not None:
            img = encode_image_fast(arch, plans["visual"], images)
            q = encode_text_fast(arch, plans["text"], query_ids)
            t = encode_text_fast(arch, plans["text"], target_ids)
        else:
            img, q, t = model.encode_image(images), model.encode_text(query_ids), model.encode_text(target_ids)
        return l2_normalize(img), l2_normalize(q), l2_normalize(t)

    return step


def encode_dataset(
    model: CLIP,
    pipeline: DataPipeline,
    batch_size: int = 256,
    use_fast: bool = False,
    quantize: Optional[str] = None,
) -> EncodedDataset:
    """Encode every example in order, on the model's device. ``use_fast``
    (implied by ``quantize``) packs both towers into serving plans first."""
    use_fast = use_fast or quantize is not None
    plans = make_encode_plans(model, dtype=model.dtype, quantize=quantize) if use_fast else None
    step = make_encode_step(model, plans)
    device = model.logit_scale.device
    imgs, qs, ts, uuids = [], [], [], []
    for batch in pipeline.epoch_batches(batch_size, shuffle=False, drop_last=False):
        img_e, q_e, t_e = step(
            torch.as_tensor(batch.images, device=device),
            torch.as_tensor(batch.query_ids, dtype=torch.long, device=device),
            torch.as_tensor(batch.target_ids, dtype=torch.long, device=device),
        )
        imgs.append(img_e.cpu().numpy())
        qs.append(q_e.cpu().numpy())
        ts.append(t_e.cpu().numpy())
        uuids.extend(batch.uuids)
    return EncodedDataset(image=np.concatenate(imgs), query=np.concatenate(qs), target=np.concatenate(ts), uuids=uuids)
