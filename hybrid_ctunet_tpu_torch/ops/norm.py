"""Normalization ops (channels-last). Port of
``hybrid_ctunet_tpu/ops/norm.py``: affine-free InstanceNorm (eps 1e-5) in
every conv path, torch-style LayerNorm (eps 1e-5, affine) in attention paths.
Statistics are fp32 whatever the activation dtype."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .act import leaky_relu


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalize each (batch, channel) of ``x`` (B, X, Y, Z, C) over space.

    Single-pass fp32 statistics E[x^2] - E[x]^2, variance clamped at 0 — the
    JAX package's form, kept so the two agree when |mean| >> std
    (``nn.InstanceNorm3d`` takes another route)."""
    xf = x.float()
    n = x.shape[1] * x.shape[2] * x.shape[3]
    s1 = xf.sum(dim=(1, 2, 3), keepdim=True)
    s2 = xf.square().sum(dim=(1, 2, 3), keepdim=True)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean.square(), min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def instance_norm_leaky(
    x: torch.Tensor, eps: float = 1e-5, negative_slope: float = 0.01
) -> torch.Tensor:
    """InstanceNorm + LeakyReLU, the conv-path epilogue."""
    return leaky_relu(instance_norm(x, eps), negative_slope)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis with elementwise affine, fp32 inside,
    returned in ``x``'s dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)
