"""Retrieval evaluation pipelines, on one device or over a device mesh.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/eval/evaluator.py``
(and of ``make_encode_step`` in its ``train/trainer.py``):

- ``encode_dataset``      — a dataset into L2-normalized image / query /
  target embeddings, in the dataset's order: on the model's device, every
  batch at its own size, or over a mesh runtime ``rt`` as the JAX version
  does: each batch padded to a multiple of the shard count, each process
  encoding its slice (``train.trainer.make_encode_step``: each data shard on
  its device, B1 / B3a / B3b once a shard with ``use_fast`` on the card),
  the gathered embeddings cut back to the batch;
- ``evaluate_clip_model`` — the 3-task metric suite;
- ``evaluate_weighted``   — the weighted T2I+T2T combined-matrix eval;
- ``fusion_sweep``        — CLIP x Text2SPARQL: (t2i, t2t) weight pairs x an
  alpha grid, weighted fusion, full metrics per cell, in query stripes;
- ``run_full_evaluation`` / ``evaluate_zeroshot`` — encode, then all of the above.

Evaluation runs in f32: the metric products are f32 ``matmul``s (TF32 off,
``cli.evaluate`` pins it), so the card and the CPU give the same ranks up to
summation order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.datasets import DataPipeline
from ..models.clip import CLIP, l2_normalize
from ..models.fast_encode import encode_image_fast, encode_text_fast, make_encode_plans
from ..utils.config import resolve_encoder
from ..utils.logging_utils import save_metrics_to_json
from . import fusion as F
from . import metrics as MET
from .metrics import as_f32


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
    rt=None,
) -> EncodedDataset:
    """Encode every example in order, on the model's device or over the
    mesh runtime ``rt``. ``use_fast`` (implied by ``quantize``) packs both
    towers into serving plans first."""
    use_fast = use_fast or quantize is not None
    if rt is not None and rt.mesh.size > 1:
        return _encode_sharded(model, pipeline, rt, batch_size, use_fast, quantize)
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


def _encode_sharded(model: CLIP, pipeline: DataPipeline, rt, batch_size: int, use_fast: bool,
                    quantize: Optional[str]) -> EncodedDataset:
    from ..train.trainer import make_encode_step as mesh_encode_step

    step = mesh_encode_step(model, rt, fast=use_fast, quantize=quantize)
    shard = rt.num_data
    eff_batch = -(-batch_size // shard) * shard  # every batch divides the data axes
    pc, pi = rt.mesh.process_count, rt.mesh.process_index
    imgs, qs, ts, uuids = [], [], [], []
    for batch in pipeline.epoch_batches(batch_size, shuffle=False, drop_last=False):
        n = batch.images.shape[0]
        arrays = [np.pad(a, [(0, eff_batch - n)] + [(0, 0)] * (a.ndim - 1))
                  for a in (batch.images, batch.query_ids, batch.target_ids)]
        local = eff_batch // pc  # each process its contiguous slice of the padded global batch
        arrays = [a[pi * local:(pi + 1) * local] for a in arrays]
        img_e, q_e, t_e = (e[:n].cpu().numpy() for e in step(None, *arrays))
        imgs.append(img_e)
        qs.append(q_e)
        ts.append(t_e)
        uuids.extend(batch.uuids)
    return EncodedDataset(image=np.concatenate(imgs), query=np.concatenate(qs), target=np.concatenate(ts), uuids=uuids)


def evaluate_clip_model(
    encoded: EncodedDataset,
    k_values: Sequence[int] = MET.DEFAULT_KS,
    tasks: Sequence[str] = MET.DEFAULT_TASKS,
    device="cuda",
) -> Dict[str, float]:
    """The standard 3-task metric suite, on ``device``."""
    q, t, i = (as_f32(x, device) for x in (encoded.query, encoded.target, encoded.image))
    return MET.compute_all_retrieval_metrics(q, t, i, k_values=k_values, tasks=tasks)


def evaluate_weighted(
    encoded: EncodedDataset,
    t2i_weight: float = 0.5,
    t2t_weight: float = 0.5,
    k_values: Sequence[int] = MET.DEFAULT_KS,
    device="cuda",
) -> Dict[str, float]:
    """Weighted combined-matrix eval, on ``device``."""
    q, t, i = (as_f32(x, device) for x in (encoded.query, encoded.target, encoded.image))
    return MET.compute_retrieval_metrics_final(q, t, i, k_values=k_values, t2i_weight=t2i_weight,
                                               t2t_weight=t2t_weight)


def fusion_sweep(
    encoded: EncodedDataset,
    text2sparql_results: Mapping[str, Sequence[str]],
    weight_pairs: Sequence[Tuple[float, float]] = ((0.5, 0.5), (0.1, 0.9)),
    alphas: Sequence[float] = (0.9, 0.8, 0.7, 0.6, 0.5, 0.4, 0.3, 0.2, 0.1),
    k_values: Sequence[int] = MET.DEFAULT_KS,
    block: int = 1024,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """CLIP x Text2SPARQL weighted-fusion sweep: for each (t2i, t2t) blend and
    each alpha, fuse the blended CLIP scores with the KG hits
    (``sparql_weight = 1 - alpha``) and compute full metrics. Returns
    ``{"t2i{a}_t2t{b}_alpha{c}": metrics}``. Every cell ranks in query
    stripes with the sparse hit bonus scatter-added per stripe: no [N, N]
    matrix is held (peak O(block * N))."""
    results: Dict[str, Dict[str, float]] = {}
    hit_idx, hit_mask, _ = F.build_hit_indices(text2sparql_results, encoded.uuids, encoded.uuids)
    q, t, i = (as_f32(x, device) for x in (encoded.query, encoded.target, encoded.image))
    for w_t2i, w_t2t in weight_pairs:
        for alpha in alphas:
            ranks = F.weighted_fusion_ranks_blocked(
                q, t, i, hit_idx, hit_mask,
                t2i_weight=w_t2i, t2t_weight=w_t2t, alpha=alpha, sparql_weight=1.0 - alpha, block=block,
            )
            results[f"t2i{w_t2i}_t2t{w_t2t}_alpha{alpha}"] = MET.metrics_from_ranks(ranks, k_values)
    return results


def run_full_evaluation(
    model: CLIP,
    pipeline: DataPipeline,
    batch_size: int = 256,
    k_values: Sequence[int] = MET.DEFAULT_KS,
    t2i_weight: float = 0.5,
    t2t_weight: float = 0.5,
    text2sparql_results: Optional[Mapping[str, Sequence[str]]] = None,
    output_json: Optional[str] = None,
    encoder: str = "flax",
    rt=None,
) -> Dict[str, object]:
    """Encode (over the mesh runtime ``rt`` when given) -> 3-task metrics ->
    weighted combined -> optional fusion sweep -> optional JSON, on the
    model's device. ``encoder``: ``flax`` (the module towers), ``fast``
    (bf16 fused layers) or ``int8`` (W8A8)."""
    use_fast, quantize = resolve_encoder(encoder)
    device = model.logit_scale.device
    encoded = encode_dataset(model, pipeline, batch_size, use_fast=use_fast, quantize=quantize, rt=rt)
    report: Dict[str, object] = {
        "num_samples": len(encoded.uuids),
        "per_task": evaluate_clip_model(encoded, k_values, device=device),
        "weighted": evaluate_weighted(encoded, t2i_weight, t2t_weight, k_values, device=device),
    }
    if text2sparql_results is not None:
        report["fusion_sweep"] = fusion_sweep(encoded, text2sparql_results, k_values=k_values, device=device)
    if output_json:
        save_metrics_to_json(report, output_json)
    return report


def evaluate_zeroshot(*args, **kwargs):
    """Zero-shot eval = full eval with pretrained weights."""
    return run_full_evaluation(*args, **kwargs)
