"""One fine-tuning step of CLIP in plain PyTorch, from the published recipe
the configuration names: the joint objective ``w_t2i * InfoNCE(target
text, image) + w_t2t * InfoNCE(query text, target text)`` (each
symmetric, weights normalized to sum 1, a fixed temperature), the gradient
of every parameter clipped to a global norm, then AdamW with decoupled
weight decay (none on ``logit_scale``) at a learning rate that is cosine
annealed once per epoch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import clip as ref_clip


def info_nce(a: torch.Tensor, b: torch.Tensor, temperature: float) -> torch.Tensor:
    logits = a @ b.t() / temperature
    labels = torch.arange(a.shape[0], device=a.device)
    return (F.cross_entropy(logits, labels) + F.cross_entropy(logits.t(), labels)) / 2


def joint_loss(img, q, t, tc: dict) -> torch.Tensor:
    s = tc["t2i_weight"] + tc["t2t_weight"]
    return (tc["t2i_weight"] / s) * info_nce(t, img, tc["temperature"]) + (tc["t2t_weight"] / s) * info_nce(q, t, tc["temperature"])


def lr_at(step: int, tc: dict, steps_per_epoch: int) -> float:
    """The learning rate of 0-based optimizer step ``step``: cosine over
    ``epochs`` from ``lr`` to ``eta_min_factor * lr``, stepped per epoch."""
    epoch = min(step // steps_per_epoch, tc["epochs"])
    lo = tc["lr"] * tc["eta_min_factor"]
    return lo + 0.5 * (tc["lr"] - lo) * (1 + math.cos(math.pi * epoch / tc["epochs"]))


class Trainer:
    """Parameters, AdamW moments and the step, all float32."""

    def __init__(self, weights: Dict[str, torch.Tensor], arch, tc: dict, steps_per_epoch: int,
                 mm: ref_clip.Exact = ref_clip.Exact(), remat: bool = True):
        self.w = {n: t.detach().clone().requires_grad_(True) for n, t in weights.items()}
        self.m = {n: torch.zeros_like(t) for n, t in weights.items()}
        self.v = {n: torch.zeros_like(t) for n, t in weights.items()}
        self.arch, self.tc, self.spe, self.mm, self.remat = arch, tc, steps_per_epoch, mm, remat
        self.count = 0

    def loss(self, images, query_ids, target_ids) -> torch.Tensor:
        a, mm = self.arch, self.mm
        img = ref_clip.encode_image(self.w, images, a, mm, self.remat)
        q = ref_clip.encode_text(self.w, query_ids, a, mm, self.remat)
        t = ref_clip.encode_text(self.w, target_ids, a, mm, self.remat)
        return joint_loss(img, q, t, self.tc)

    def step(self, images, query_ids, target_ids) -> Tuple[float, Dict[str, torch.Tensor]]:
        """One step; returns the loss and each leaf's clipped gradient."""
        tc = self.tc
        loss = self.loss(images, query_ids, target_ids)
        names = list(self.w)
        grads = torch.autograd.grad(loss, [self.w[n] for n in names], allow_unused=True)
        grads = {n: (torch.zeros_like(self.w[n]) if g is None else g) for n, g in zip(names, grads)}
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
        factor = torch.clamp(tc["grad_clip_norm"] / norm, max=1.0)
        grads = {n: g * factor for n, g in grads.items()}
        lr = lr_at(self.count, tc, self.spe)
        self.count += 1
        b1, b2, eps = tc["beta1"], tc["beta2"], tc["eps"]
        c1, c2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        with torch.no_grad():
            for n, p in self.w.items():
                g = grads[n]
                wd = 0.0 if n == "logit_scale" else tc["weight_decay"]
                p.mul_(1 - lr * wd)
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                p.addcdiv_(self.m[n] / c1, (self.v[n] / c2).sqrt() + eps, value=-lr)
        return float(loss.detach()), grads


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], names: List[str]) -> Tuple[float, str]:
    """The worst leaf's ``|prog - ref| / max(ref, median ref)`` over
    ``names``, and that leaf."""
    vals = sorted(ref[n] for n in names)
    med = vals[len(vals) // 2]
    worst, at = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst:
            worst, at = gap, n
    return worst, at
