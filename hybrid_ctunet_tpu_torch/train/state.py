"""The optimizer factory. Port of ``hybrid_ctunet_tpu/train/state.py``.

The reference's choices (main_CTUNet.py:190-199): AdamW (betas 0.9/0.999,
eps 1e-8, decoupled weight decay on every parameter), Adam with L2-coupled
decay, and Nesterov SGD. The LR is set per epoch (:func:`set_learning_rate`)
from the schedule. Parameters and optimizer state are fp32; the models
compute in bf16 where the reference uses AMP, with no loss scaling (bf16
keeps fp32's exponent range).
"""
from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], optim_name: str = "adamw", *,
                   reg_weight: float = 1e-5, momentum: float = 0.99) -> torch.optim.Optimizer:
    if optim_name == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=reg_weight)
    if optim_name == "adam":  # torch Adam's weight_decay is L2 added to the gradient
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=reg_weight)
    if optim_name == "sgd":
        return torch.optim.SGD(params, lr=0.0, momentum=momentum, nesterov=True,
                               weight_decay=reg_weight)
    raise ValueError(f"Unsupported Optimization Procedure: {optim_name}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
