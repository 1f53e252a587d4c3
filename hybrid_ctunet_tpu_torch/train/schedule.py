"""Learning-rate schedules, stepped once per epoch as in the reference. Port
of ``hybrid_ctunet_tpu/train/schedule.py``.

``warmup_cosine_lr`` is the closed form of the reference's
``LinearWarmupCosineAnnealingLR`` (optimizers/lr_scheduler.py:92-177):
linear warmup from ``warmup_start_lr`` over ``warmup_epochs`` (the reference
divides by ``warmup_epochs - 1``, so the base LR is reached at epoch
``warmup_epochs - 1``), then a cosine to ``eta_min`` at ``max_epochs``.
"""
from __future__ import annotations

import math
from typing import Callable


def warmup_cosine_lr(epoch: int, *, base_lr: float, warmup_epochs: int, max_epochs: int,
                     warmup_start_lr: float = 0.0, eta_min: float = 0.0) -> float:
    e = float(epoch)
    if e < warmup_epochs:
        return warmup_start_lr + e * (base_lr - warmup_start_lr) / max(warmup_epochs - 1, 1)
    progress = (e - warmup_epochs) / max(max_epochs - warmup_epochs, 1)
    return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * progress))


def make_epoch_schedule(name: str, *, base_lr: float, warmup_epochs: int,
                        max_epochs: int) -> Callable[[int], float]:
    """The reference's ``--lrschedule`` choices (main_CTUNet.py:201-210):
    'warmup_cosine', 'cosine_anneal', anything else constant."""
    if name == "warmup_cosine":
        return lambda epoch: warmup_cosine_lr(
            epoch, base_lr=base_lr, warmup_epochs=warmup_epochs, max_epochs=max_epochs)
    if name == "cosine_anneal":
        return lambda epoch: 0.5 * base_lr * (1.0 + math.cos(math.pi * epoch / max_epochs))
    return lambda epoch: base_lr
