"""Stage-2 training and evaluation of learned fusion heads, on one device.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/train/fusion_trainer.py``.
A head trains on frozen CLIP embeddings with a symmetric diagonal-label
cross-entropy over its fused [B, B] score block scaled by 1 / temperature
(InfoNCE on fused scores), with Adam (``optax.adam``'s defaults). The batch
order is the JAX trainer's: ``np.random.default_rng(seed).permutation(n)``
each epoch, ``max(1, n // batch_size)`` steps, batches of fewer than two
rows skipped. Dropout masks draw from a ``torch.Generator`` seeded with
``seed`` on the embeddings' device.

The head artifact is the JAX package's ``.npz``: ``__fusion_type__``,
``__embed_dim__`` and ``param:<flax path>`` entries in flax layouts
(``models.fusion_heads.fusion_params_to_flax``), written by an atomic
replace, so a head that either package trained serves in the other.
"""

from __future__ import annotations

import io
import logging
import os
from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..eval.metrics import DEFAULT_KS, as_f32, compute_retrieval_metrics_fusion
from ..models.fusion_heads import FusionModel, fusion_params_to_flax, head_state_numpy

if TYPE_CHECKING:
    from ..eval.evaluator import EncodedDataset

logger = logging.getLogger("kemr_torch.fusion_train")


def fusion_loss(scores: torch.Tensor, temperature: float) -> torch.Tensor:
    """Symmetric CE with diagonal labels over ``scores / temperature``."""
    s = scores / temperature
    rows = torch.arange(s.shape[0], device=s.device)
    logp_r = F.log_softmax(s, dim=-1)
    logp_c = F.log_softmax(s.T, dim=-1)
    return -(torch.mean(logp_r[rows, rows]) + torch.mean(logp_c[rows, rows])) / 2


def train_fusion_head(
    fm: FusionModel,
    encoded: "EncodedDataset",
    epochs: int = 10,
    batch_size: int = 64,
    lr: float = 1e-3,
    temperature: float = 0.07,
    seed: int = 42,
    params: Optional[torch.nn.Module] = None,
    device="cuda",
) -> Tuple[torch.nn.Module, Dict[str, list]]:
    """Train a head on frozen embeddings; returns ``(head, history)``.
    ``params`` (a head module) continues training it in place; without one a
    head is drawn from ``seed`` on ``device``."""
    if params is None:
        params = fm.init(seed, device)
    device = next(params.parameters()).device
    opt = torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    drop = torch.Generator(device=device).manual_seed(seed)
    q_all, i_all, t_all = (as_f32(x, device) for x in (encoded.query, encoded.image, encoded.target))
    n = q_all.shape[0]
    steps = max(1, n // batch_size)

    history: Dict[str, list] = {"loss": []}
    np_rng = np.random.default_rng(seed)
    for epoch in range(epochs):
        order = np_rng.permutation(n)
        epoch_loss = 0.0
        for s in range(steps):
            idx = torch.as_tensor(order[s * batch_size : (s + 1) * batch_size], device=device)
            if idx.shape[0] < 2:
                continue
            scores = fm.scores(params, q_all[idx], i_all[idx], t_all[idx], deterministic=False, generator=drop)
            loss = fusion_loss(scores, temperature)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            epoch_loss += loss.item()
        history["loss"].append(epoch_loss / steps)
        logger.info("fusion head epoch %d: loss=%.4f", epoch, history["loss"][-1])
    return params, history


def save_fusion_head(path: str, fm: FusionModel, params: torch.nn.Module) -> None:
    """Write a head as one self-describing ``.npz`` artifact (atomic replace):
    ``cli.serve --fusion.head_params=<path>`` needs nothing else."""
    flat = fusion_params_to_flax(head_state_numpy(params))
    buf = io.BytesIO()
    np.savez(
        buf,
        __fusion_type__=np.asarray(fm.fusion_type),
        __embed_dim__=np.asarray(fm.embed_dim),
        **{f"param:{k}": np.asarray(v) for k, v in flat.items()},
    )
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def load_fusion_head(path: str, device="cuda") -> Tuple[FusionModel, torch.nn.Module]:
    """Load a :func:`save_fusion_head` artifact (either package's) ->
    ``(FusionModel, head on device)``."""
    with np.load(path) as z:
        fm = FusionModel(str(z["__fusion_type__"]), int(z["__embed_dim__"]))
        flat = {k[len("param:"):]: z[k] for k in z.files if k.startswith("param:")}
    return fm, fm.from_flax(flat, device)


@torch.no_grad()
def evaluate_fusion_model(
    fm: FusionModel,
    params: torch.nn.Module,
    encoded: "EncodedDataset",
    k_values: Sequence[int] = DEFAULT_KS,
    block_q: int = 64,
    block_c: int = 512,
    baseline_weights: Tuple[float, float] = (0.5, 0.5),
) -> Dict[str, object]:
    """Blockwise fused-matrix metrics, the linear baseline at
    ``baseline_weights`` and the four score statistics, on the head's device."""
    device = next(params.parameters()).device
    q, i, t = (as_f32(x, device) for x in (encoded.query, encoded.image, encoded.target))
    fused = fm.blockwise_scores(params, q, i, t, block_q=block_q, block_c=block_c)
    metrics = compute_retrieval_metrics_fusion(fused, prefix="FUSION", k_values=k_values)
    w_t2i, w_t2t = baseline_weights
    baseline = w_t2i * (q @ i.T) + w_t2t * (q @ t.T)
    stats = {
        "fused_mean": float(torch.mean(fused)),
        "fused_std": float(torch.std(fused, correction=0)),
        "baseline_mean": float(torch.mean(baseline)),
        "baseline_std": float(torch.std(baseline, correction=0)),
    }
    metrics_baseline = compute_retrieval_metrics_fusion(baseline, prefix="BASELINE", k_values=k_values)
    return {"fusion": metrics, "baseline": metrics_baseline, "score_stats": stats}
