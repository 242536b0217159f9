"""Knowledge distillation: a small student tower learns a large teacher's
retrieval geometry.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/train/distill.py``:

- the teacher never runs in the train loop: its embeddings are encoded once
  per split (``eval.evaluator.encode_dataset``, the ``int8`` serving towers
  if asked) and stored row-aligned with the uuids
  (:func:`save_encoded_dataset`, the JAX package's ``.npz``: either package
  reads the other's);
- the loss matches the softmax rows of the student's in-batch T2I and T2T
  similarity matrices to the teacher's (KL, both directions, temperature
  scaled, the task weights), which needs no equal dimensions; an optional
  cosine term (``distill_embed_weight``) pins the vectors when they match.

``TrainConfig.distill_teacher`` makes ``CLIPTrainer`` take :func:`make_distill_step`.
"""

from __future__ import annotations

import io
import os
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from ..eval.evaluator import EncodedDataset
from ..models.clip import CLIP, l2_normalize
from ..utils.config import TrainConfig


def save_encoded_dataset(path: str, enc: EncodedDataset) -> None:
    """An :class:`EncodedDataset` as one ``.npz`` (atomic replace; ``uuids``
    an object array, read with ``allow_pickle=True``)."""
    buf = io.BytesIO()
    np.savez(
        buf,
        image=np.asarray(enc.image, np.float32),
        query=np.asarray(enc.query, np.float32),
        target=np.asarray(enc.target, np.float32),
        uuids=np.asarray(enc.uuids, dtype=object),
    )
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    os.replace(tmp, path)


def load_encoded_dataset(path: str) -> EncodedDataset:
    with np.load(path, allow_pickle=True) as z:
        return EncodedDataset(image=z["image"], query=z["query"], target=z["target"],
                              uuids=[str(u) for u in z["uuids"]])


class TeacherBank:
    """uuid -> teacher row, for batch assembly on the host."""

    def __init__(self, enc: EncodedDataset):
        self.enc = enc
        self._row = {u: i for i, u in enumerate(enc.uuids)}
        if len(self._row) != len(enc.uuids):
            raise ValueError("teacher EncodedDataset has duplicate uuids")

    @property
    def dim(self) -> int:
        return int(self.enc.image.shape[1])

    def rows(self, uuids: Sequence[str]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        try:
            idx = np.asarray([self._row[u] for u in uuids])
        except KeyError as e:
            raise KeyError(f"uuid {e.args[0]!r} not in the teacher embeddings") from None
        return self.enc.image[idx], self.enc.query[idx], self.enc.target[idx]


def _kl_rows(t_logits: torch.Tensor, s_logits: torch.Tensor) -> torch.Tensor:
    """Row-mean KL(teacher || student) of the softmaxed logits: 0 at a match."""
    p = torch.softmax(t_logits, dim=-1)
    return (p * (torch.log_softmax(t_logits, dim=-1) - torch.log_softmax(s_logits, dim=-1))).sum(-1).mean()


def distill_loss(
    s_img: torch.Tensor,
    s_q: torch.Tensor,
    s_t: torch.Tensor,
    t_img: torch.Tensor,
    t_q: torch.Tensor,
    t_t: torch.Tensor,
    *,
    temperature: float = 0.07,
    t2i_weight: float = 0.7,
    t2t_weight: float = 0.3,
    kd_weight: float = 1.0,
    embed_weight: float = 0.5,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The KD objective of one batch of L2-normalized student ``[B, D_s]``
    and teacher ``[B, D_t]`` embeddings (or ``[S, B, D]``: each data shard's
    own in-batch matrices, the mean over the shards): ``(loss, {loss, loss_kd,
    loss_embed})`` with ``loss = kd_weight * kd + embed_weight * embed``;
    ``kd`` is the task-weighted row KL of the T2I and T2T similarity matrices
    (both directions), ``embed`` is ``1 - cos`` over the three modalities
    (equal dimensions only: callers guard)."""
    total = t2i_weight + t2t_weight
    w_t2i, w_t2t = t2i_weight / total, t2t_weight / total
    s_img, s_q, s_t, t_img, t_q, t_t = (x.float() for x in (s_img, s_q, s_t, t_img, t_q, t_t))

    def pair_kd(sa, sb, ta, tb):
        s_logits = sa @ sb.mT / temperature
        t_logits = ta @ tb.mT / temperature
        return 0.5 * (_kl_rows(t_logits, s_logits) + _kl_rows(t_logits.mT, s_logits.mT))

    kd = w_t2i * pair_kd(s_q, s_img, t_q, t_img) + w_t2t * pair_kd(s_q, s_t, t_q, t_t)
    if embed_weight > 0.0:
        cos = ((s_img * t_img).sum(-1).mean() + (s_q * t_q).sum(-1).mean() + (s_t * t_t).sum(-1).mean()) / 3.0
        embed = 1.0 - cos
    else:
        embed = torch.zeros((), dtype=torch.float32, device=kd.device)
    loss = kd_weight * kd + embed_weight * embed
    return loss, {"loss": loss, "loss_kd": kd, "loss_embed": embed}


def check_dims(cfg: TrainConfig, student_dim: int, teacher_dim: int) -> None:
    if cfg.distill_embed_weight > 0.0 and student_dim != teacher_dim:
        raise ValueError(
            f"distill_embed_weight > 0 needs matching embed dims (student {student_dim} vs teacher {teacher_dim}); "
            f"set --train.distill_embed_weight=0 for cross-dimension distillation"
        )


def make_distill_step(model: CLIP, cfg: TrainConfig, student_dim: int, teacher_dim: int, rt=None) -> Callable:
    """``distill_step(state, batch) -> (state, metrics)``: the student's three
    embeddings of the batch against its ``t_img`` / ``t_q`` / ``t_t`` teacher
    rows under :func:`distill_loss`, backward, the optimizer; ``metrics``
    are the loss's keys and ``grad_norm`` (0-dim device tensors). Over a
    mesh runtime ``rt`` it is the data-parallel step (JAX
    ``make_distill_step``): each data shard's KD on its own in-batch
    matrices, gradients and metrics the shards' mean."""
    from .trainer import _ShardedStep, apply_gradients, collect_grads  # the trainer imports this module

    check_dims(cfg, student_dim, teacher_dim)
    loss_kw = dict(temperature=cfg.temperature, t2i_weight=cfg.t2i_weight, t2t_weight=cfg.t2t_weight,
                   kd_weight=cfg.distill_kd_weight, embed_weight=cfg.distill_embed_weight)
    if rt is not None:
        return _ShardedStep(model, cfg, rt, distill=lambda s_img, s_q, s_t, teacher: distill_loss(
            s_img, s_q, s_t, *teacher, **loss_kw))
    params = dict(model.named_parameters())

    def distill_step(state, batch: Dict[str, torch.Tensor]):
        s_img = l2_normalize(model.encode_image(batch["images"]))
        s_q = l2_normalize(model.encode_text(batch["query_ids"]))
        s_t = l2_normalize(model.encode_text(batch["target_ids"]))
        loss, metrics = distill_loss(s_img, s_q, s_t, batch["t_img"], batch["t_q"], batch["t_t"], **loss_kw)
        for p in params.values():
            p.grad = None
        loss.backward()
        return apply_gradients(state, collect_grads(params), {k: v.detach() for k, v in metrics.items()})

    return distill_step
