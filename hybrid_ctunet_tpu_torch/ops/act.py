"""Activations (reference choices: LeakyReLU 0.01 in conv paths, exact erf
GELU in transformer MLPs). Port of ``hybrid_ctunet_tpu/ops/act.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")
