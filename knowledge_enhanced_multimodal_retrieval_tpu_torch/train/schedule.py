"""Learning-rate schedules.

Counterpart of ``knowledge_enhanced_multimodal_retrieval_tpu/train/schedule.py``.
The reference steps ``CosineAnnealingLR(T_max=epochs, eta_min=0.1*lr)`` once
per *epoch*; ``cosine_annealing_lr`` keeps that epoch granularity as a step
function of the optimizer step, so the learning rate matches the reference
run epoch for epoch.
"""

from __future__ import annotations

import math
from typing import Callable


def cosine_annealing_lr(
    base_lr: float,
    epochs: int,
    steps_per_epoch: int,
    eta_min_factor: float = 0.1,
    warmup_steps: int = 0,
) -> Callable[[int], float]:
    """Returns ``f(step) -> lr`` for the 0-based optimizer step.

    The epoch is ``min(step // steps_per_epoch, epochs)``; ``warmup_steps > 0``
    multiplies the first optimizer steps by the ramp ``(step + 1) / warmup_steps``
    while the cosine stays keyed on the raw step."""
    eta_min = base_lr * eta_min_factor

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, epochs)
        lr = eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * epoch / epochs))
        if warmup_steps > 0:
            lr *= min(1.0, (step + 1.0) / warmup_steps)
        return lr

    return schedule
