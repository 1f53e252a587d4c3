"""Normalization ops (channels-last). Port of
``hybrid_ctunet_tpu/ops/norm.py``: affine-free InstanceNorm (eps 1e-5) in
every conv path, torch-style LayerNorm (eps 1e-5, affine) in attention paths.
Statistics are fp32 whatever the activation dtype.

InstanceNorm (+ LeakyReLU) is kernel module K8: ``instance_norm`` and
``instance_norm_leaky`` take the plain version for CPU tensors and launch
``csrc/instance_norm.cu`` for CUDA tensors (the port of
``hybrid_ctunet_tpu/ops/norm_pallas.py``). Both follow the JAX default path
(``ops/norm.py:32-58``), not the Pallas kernel: the variance is clamped at 0
and y is rounded to the activation dtype before the LeakyReLU. The backward
recomputes through the plain version (``norm_pallas.py:98-114``).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import kernels
from .act import leaky_relu
from .recompute import recompute

_THREADS = 256  # csrc/instance_norm.cu: threads per block
_SMS = 132  # H100 SXM streaming multiprocessors


def reference_instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
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


def supports(x: torch.Tensor) -> bool:
    """Where the kernel engages: bf16 NDHWC with C/8 dividing the block's
    256 threads (C 8..2048 in powers of two; every conv width of the three
    models, 32-1024)."""
    c = x.shape[-1]
    return x.dtype == torch.bfloat16 and x.ndim == 5 and c % 8 == 0 and _THREADS % (c // 8) == 0


def num_splits(batch: int, spatial: int, channels: int) -> int:
    """Splits of the spatial axis in the statistics pass: about four blocks
    per SM over the whole call, each split at least four of a block's row
    iterations (so the deep 6x6x12 calls stay few blocks and the 96^3 calls
    fill the card)."""
    rows_per_iter = _THREADS // (channels // 8)
    by_work = max(1, spatial // (4 * rows_per_iter))
    return max(1, min(by_work, -(-4 * _SMS // batch)))


def _launch(x: torch.Tensor, eps: float, negative_slope) -> torch.Tensor:
    """K8 on a CUDA tensor: statistics (split reduction into a workspace),
    fixed-order combine, normalize [+ LeakyReLU]."""
    if not supports(x):
        raise ValueError(f"instance_norm kernel: unsupported {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    B, C = x.shape[0], x.shape[-1]
    S = x.shape[1] * x.shape[2] * x.shape[3]
    splits = num_splits(B, S, C)
    # partial sums (B, splits, 2, C), then mean and rstd (B, 2, C)
    work = torch.empty(B * splits * 2 * C + B * 2 * C, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fn = kernels.bind(
        "instance_norm", "instance_norm", ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    )
    act = negative_slope is not None
    err = fn(x.data_ptr(), out.data_ptr(), work.data_ptr(), B, S, C, splits, eps, int(act),
             float(negative_slope) if act else 0.0, kernels.stream_ptr(x.device))
    kernels.check(err, "instance_norm")
    instance_norm.launches += 1
    return out


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Affine-free InstanceNorm of (B, X, Y, Z, C). CPU tensors take the
    plain version; CUDA tensors launch ``csrc/instance_norm.cu``,
    differentiable through the plain version."""
    if not x.is_cuda:
        return reference_instance_norm(x, eps)
    return recompute(lambda x: _launch(x, eps, None), lambda x: reference_instance_norm(x, eps), x)


instance_norm.launches = 0


def instance_norm_leaky(
    x: torch.Tensor, eps: float = 1e-5, negative_slope: float = 0.01
) -> torch.Tensor:
    """InstanceNorm + LeakyReLU, the conv-path epilogue; the same kernel
    (counted on ``instance_norm``) with the activation in its store."""
    def plain(x):
        return leaky_relu(reference_instance_norm(x, eps), negative_slope)

    if not x.is_cuda:
        return plain(x)
    return recompute(lambda x: _launch(x, eps, negative_slope), plain, x)


def layer_norm(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the last axis with elementwise affine, fp32 inside,
    returned in ``x``'s dtype."""
    y = F.layer_norm(x.float(), (x.shape[-1],), weight.float(), bias.float(), eps)
    return y.to(x.dtype)
