"""Contrastive losses for joint T2I + T2T fine-tuning.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/train/losses.py``:
symmetric InfoNCE, the normalized-weight joint T2I + T2T combination (T2I
pairs *target text <-> image*, T2T *query <-> target text*), the SigLIP
pairwise sigmoid loss and the Matryoshka wrapper, each returning
``(loss, metrics)`` with the JAX package's metric keys. Logits are f32
whatever the embeddings' dtype.

``axis_name`` names the mesh axes whose gather gives global-batch
negatives, as in the JAX package. A step over several data shards passes
each feature as ``[S, B, D]``: this process's ``S`` shards of ``B`` rows,
each shard scored as the JAX package's ``shard_map`` body scores it. With
``axis_name`` the columns are every shard's rows, this process's and (under
``torch.distributed``) every other process's, gathered in global shard
order (``parallel.sharding.all_gather_autograd``: its backward hands each
process the sum of its rows' cotangents, JAX's ``psum_scatter``), and shard
*s* labels its rows ``offset_s + rows``; without it each shard sees only
its own rows. Losses and metrics are the mean over this process's shards
(the per-shard values averaged, as ``pmean`` over them); ``[B, D]``
features are one shard.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.similarity import prefix_normalize
from ..parallel.sharding import all_gather_autograd

Metrics = Dict[str, torch.Tensor]


def process_group():
    """The ``torch.distributed`` group of a run of more than one process, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """``[..., B, D]`` shards -> ``[N, D]``: every shard's rows of every
    process in global shard order (process-major), differentiably."""
    flat = x.reshape(-1, x.shape[-1])
    group = process_group()
    return flat if group is None else torch.cat(all_gather_autograd(flat, group))


def _labels(a: torch.Tensor, axis_name) -> torch.Tensor:
    """Each row's column: its row within its shard, offset by the shard's
    first global row under ``axis_name``; ``a.shape[:-1]``."""
    b = a.shape[-2]
    rows = torch.arange(b, device=a.device)
    if axis_name is None:
        return rows.expand(a.shape[:-1])
    s = a.shape[0] if a.ndim == 3 else 1
    group = process_group()
    first = 0 if group is None else torch.distributed.get_rank(group) * s
    shard = torch.arange(first, first + s, device=a.device)[:, None]
    return (shard * b + rows).reshape(a.shape[:-1])


def _pool(x: torch.Tensor, extra: Optional[torch.Tensor], axis_name) -> torch.Tensor:
    """The candidate columns: ``x``'s rows (gathered under ``axis_name``),
    then the extra rows (gathered the same way)."""
    if axis_name is not None:
        x = gather_rows(x)
        extra = None if extra is None else gather_rows(extra.float())
    return x if extra is None else torch.cat([x, extra.float()], dim=-2)


def _at(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return logp.gather(-1, labels.unsqueeze(-1)).squeeze(-1)


def info_nce(
    features_a: torch.Tensor,
    features_b: torch.Tensor,
    temperature: float = 0.07,
    axis_name=None,
    negatives_a: Optional[torch.Tensor] = None,
    negatives_b: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Metrics]:
    """Symmetric InfoNCE over L2-normalized features ``[B, D]`` (or ``[S, B, D]``).

    ``negatives_b`` (``[K, D]``, ``[S, K, D]``) appends candidate rows to
    the a->b direction's denominator and ``negatives_a`` to b->a:
    competition, never labels; under ``axis_name`` they are gathered like
    the batch."""
    a, b = features_a.float(), features_b.float()
    labels = _labels(a, axis_name)
    logp_ab = F.log_softmax((a @ _pool(b, negatives_b, axis_name).mT) / temperature, dim=-1)
    logp_ba = F.log_softmax((b @ _pool(a, negatives_a, axis_name).mT) / temperature, dim=-1)
    loss_a2b = -_at(logp_ab, labels).mean()
    loss_b2a = -_at(logp_ba, labels).mean()
    loss = (loss_a2b + loss_b2a) / 2.0
    return loss, {"loss": loss, "loss_a2b": loss_a2b, "loss_b2a": loss_b2a}


def sigmoid_contrastive(
    features_a: torch.Tensor,
    features_b: torch.Tensor,
    temperature: float = 0.1,
    bias: float = -10.0,
    axis_name=None,
    negatives_a: Optional[torch.Tensor] = None,
    negatives_b: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Metrics]:
    """SigLIP pairwise sigmoid loss (Zhai et al. 2023): ``-log sigmoid(z *
    (sim / temperature + bias))`` with ``z`` = +1 on the diagonal and -1 off
    it, summed over a row and averaged over the rows. Mined extras add pure
    negative pairs at the same per-row scale."""
    a, b = features_a.float(), features_b.float()
    logits = (a @ _pool(b, None, axis_name).mT) / temperature + bias
    z = 2.0 * F.one_hot(_labels(a, axis_name), logits.shape[-1]).float() - 1.0
    loss = -F.logsigmoid(z * logits).sum(-1).mean()
    if negatives_b is not None:
        neg = (a @ _pool(negatives_b.float(), None, axis_name).mT) / temperature + bias
        loss = loss - F.logsigmoid(-neg).sum(-1).mean()
    if negatives_a is not None:
        neg = (b @ _pool(negatives_a.float(), None, axis_name).mT) / temperature + bias
        loss = loss - F.logsigmoid(-neg).sum(-1).mean()
    return loss, {"loss": loss}


def _joint(pair_loss, image_features, query_features, target_features, t2i_weight, t2t_weight, neg_text_features,
           **kw) -> Tuple[torch.Tensor, Metrics]:
    wsum = t2i_weight + t2t_weight
    w_t2i, w_t2t = t2i_weight / wsum, t2t_weight / wsum
    # mined negatives are TARGET texts: in T2I (a = target, b = image) they
    # extend the image->text pool, in T2T (a = query, b = target) the
    # query->target pool
    loss_t2i, _ = pair_loss(target_features, image_features, negatives_a=neg_text_features, **kw)
    loss_t2t, _ = pair_loss(query_features, target_features, negatives_b=neg_text_features, **kw)
    total = w_t2i * loss_t2i + w_t2t * loss_t2t
    # torch.full fills on the device; torch.tensor would copy from the host
    # and wait for the device mid-step
    weight = functools.partial(torch.full, (), dtype=torch.float32, device=total.device)
    return total, {
        "loss": total,
        "loss_t2i": loss_t2i,
        "loss_t2t": loss_t2t,
        "t2i_weight": weight(w_t2i),
        "t2t_weight": weight(w_t2t),
    }


def joint_contrastive_loss(
    image_features: torch.Tensor,
    query_features: torch.Tensor,
    target_features: torch.Tensor,
    temperature: float = 0.07,
    t2i_weight: float = 0.5,
    t2t_weight: float = 0.5,
    axis_name=None,
    neg_text_features: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Metrics]:
    """``w_t2i * InfoNCE(target, image) + w_t2t * InfoNCE(query, target)``,
    the weights normalized to sum 1."""
    return _joint(info_nce, image_features, query_features, target_features, t2i_weight, t2t_weight,
                  neg_text_features, temperature=temperature, axis_name=axis_name)


def joint_sigmoid_loss(
    image_features: torch.Tensor,
    query_features: torch.Tensor,
    target_features: torch.Tensor,
    temperature: float = 0.1,
    t2i_weight: float = 0.5,
    t2t_weight: float = 0.5,
    bias: float = -10.0,
    axis_name=None,
    neg_text_features: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Metrics]:
    """:func:`joint_contrastive_loss` with :func:`sigmoid_contrastive` parts."""
    return _joint(sigmoid_contrastive, image_features, query_features, target_features, t2i_weight, t2t_weight,
                  neg_text_features, temperature=temperature, bias=bias, axis_name=axis_name)


def matryoshka_joint_loss(base_joint: Callable, dims) -> Callable:
    """Matryoshka Representation Learning (Kusupati et al. 2022): the mean of
    ``base_joint`` over prefix-truncated, re-normalized embeddings, the full
    width always included (appended when absent), with ``loss_d{d}`` per
    prefix beside the averaged ``loss_t2i`` / ``loss_t2t``."""
    dims = tuple(dict.fromkeys(int(d) for d in dims))
    if not dims or any(d <= 0 for d in dims):
        raise ValueError(f"matryoshka dims must be positive ints, got {dims!r}")

    def joint(image_features, query_features, target_features, neg_text_features=None, **kw):
        full = image_features.shape[-1]
        if any(d > full for d in dims):
            raise ValueError(f"matryoshka dims {dims} exceed the embedding width {full}")
        all_dims = dims if full in dims else dims + (full,)
        total = 0.0
        acc: Metrics = {}
        per_dim: Metrics = {}
        for d in all_dims:
            loss_d, m = base_joint(
                prefix_normalize(image_features, d),
                prefix_normalize(query_features, d),
                prefix_normalize(target_features, d),
                neg_text_features=None if neg_text_features is None else prefix_normalize(neg_text_features, d),
                **kw,
            )
            total = total + loss_d
            per_dim[f"loss_d{d}"] = loss_d
            for key in ("loss_t2i", "loss_t2t"):
                if key in m:
                    acc[key] = acc.get(key, 0.0) + m[key]
        n = float(len(all_dims))
        total = total / n
        return total, {"loss": total, **{k: v / n for k, v in acc.items()}, **per_dim}

    return joint


def joint_loss_for_config(cfg) -> Callable:
    """``TrainConfig.loss`` (and ``matryoshka_dims``) as a joint-loss callable
    with the :func:`joint_contrastive_loss` signature."""
    if cfg.loss == "infonce":
        base = joint_contrastive_loss
    elif cfg.loss == "siglip":
        base = functools.partial(joint_sigmoid_loss, bias=cfg.sigmoid_bias)
    else:
        raise ValueError(f"train.loss must be 'infonce' or 'siglip', got {cfg.loss!r}")
    if cfg.matryoshka_dims:
        return matryoshka_joint_loss(base, cfg.matryoshka_dims)
    return base
