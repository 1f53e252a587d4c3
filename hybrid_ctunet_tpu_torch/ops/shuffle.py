"""Anisotropic 3D pixel shuffle + per-voxel Linear (kernel module K5). Port
of the pixel-shuffle half of ``hybrid_ctunet_tpu/ops/shuffle_pallas.py``
(``reference_shuffle``, ``fused_pixel_shuffle``).

The channel dim splits as (C', f0, f1, f2) with C' slowest; the factor
offsets interleave into space; then Linear(C' -> F) + bias. ``w`` is in
torch's Linear layout (F, C').
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import kernels

_BM = 64  # csrc/pixel_shuffle.cu: GEMM rows per block
_BN = 64  # output features per block


def reference_shuffle(x, w, b, factor: Tuple[int, int, int], dtype):
    """Plain version (models/layers.py PixelShuffleLinear default branch)."""
    B, X, Y, Z, C = x.shape
    f0, f1, f2 = factor
    cp = C // (f0 * f1 * f2)
    h = x.reshape(B, X, Y, Z, cp, f0, f1, f2).permute(0, 1, 5, 2, 6, 3, 7, 4)
    h = h.reshape(B, X * f0, Y * f1, Z * f2, cp)
    return torch.matmul(h.to(dtype), w.to(dtype).t()) + b.to(dtype)


def supports(c: int, factor: Tuple[int, int, int], features: int, dtype) -> bool:
    div = factor[0] * factor[1] * factor[2]
    return (
        dtype == torch.bfloat16
        and _BM % div == 0
        and c % div == 0
        and (c // div) % 16 == 0
        and features % _BN == 0
    )


def pixel_shuffle_linear(x, w, b, factor: Tuple[int, int, int], dtype):
    """x (B, X, Y, Z, C) -> (B, X*f0, Y*f1, Z*f2, F). CPU tensors take the
    plain version; CUDA tensors launch ``csrc/pixel_shuffle.cu``."""
    if not x.is_cuda:
        return reference_shuffle(x, w, b, factor, dtype)
    B, X, Y, Z, C = x.shape
    f0, f1, f2 = (int(f) for f in factor)
    F, cp = w.shape
    if not supports(C, (f0, f1, f2), F, dtype) or cp * f0 * f1 * f2 != C:
        raise ValueError(f"pixel_shuffle_linear kernel: unsupported C={C} factor={factor} "
                         f"F={F} {dtype}")
    if x.dtype != dtype:
        raise TypeError(f"x is {x.dtype}, compute dtype {dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        raise RuntimeError("pixel_shuffle_linear has no backward")
    x = x.contiguous()
    wk = w.to(dtype).contiguous()
    bk = b.to(dtype).contiguous()
    if not (wk.is_cuda and bk.is_cuda):
        raise ValueError("weights must be on the input's CUDA device")
    out = torch.empty((B, X * f0, Y * f1, Z * f2, F), dtype=dtype, device=x.device)
    fn = kernels.bind(
        "pixel_shuffle", "pixel_shuffle_linear",
        *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 9, ctypes.c_void_p,
    )
    err = fn(x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(),
             B, X, Y, Z, f0, f1, f2, cp, F, kernels.stream_ptr(x.device))
    kernels.check(err, "pixel_shuffle_linear")
    pixel_shuffle_linear.launches += 1
    return out


pixel_shuffle_linear.launches = 0
