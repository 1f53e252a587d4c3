"""Sliding-window blend accumulation (kernel module K1).

Port of ``hybrid_ctunet_tpu/ops/scatter_pallas.py`` together with the chunk
body that feeds it (``infer/sliding_window.py:256-267``). The canvas is one
fp32 tensor (X, Y, Z, C+1) whose last channel is the count map; a chunk's
window predictions are weighted by the importance map and added in window
order:

    acc[win, :C] += importance * float(pred)
    acc[win, C]  += importance

The JAX package's merged ``Z*K`` lanes are a TPU DMA contract and are not
ported. The canvas is updated in place (the JAX function returns a new one).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from .. import kernels


def reference_scatter_add_windows(
    acc: torch.Tensor, pred: torch.Tensor, importance: torch.Tensor, starts: Sequence
) -> torch.Tensor:
    """Plain version: the sequential window loop of the reference blend."""
    C = pred.shape[-1]
    rx, ry, rz = importance.shape
    for i, (x0, y0, z0) in enumerate(np.asarray(starts, np.int64).reshape(-1, 3).tolist()):
        win = acc[x0 : x0 + rx, y0 : y0 + ry, z0 : z0 + rz]
        win[..., :C] += importance[..., None] * pred[i].float()
        win[..., C] += importance
    return acc


def _check(acc, pred, importance, starts_np):
    if acc.dtype != torch.float32 or importance.dtype != torch.float32:
        raise TypeError("canvas and importance must be float32")
    if pred.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"predictions must be float32 or bfloat16, got {pred.dtype}")
    if acc.ndim != 4 or pred.ndim != 5 or importance.ndim != 3:
        raise ValueError("expected acc (X,Y,Z,C+1), pred (n,rx,ry,rz,C), importance (rx,ry,rz)")
    if acc.shape[-1] != pred.shape[-1] + 1 or tuple(pred.shape[1:4]) != tuple(importance.shape):
        raise ValueError(f"shape mismatch: acc {tuple(acc.shape)}, pred {tuple(pred.shape)}, "
                         f"importance {tuple(importance.shape)}")
    if starts_np.shape != (pred.shape[0], 3):
        raise ValueError(f"starts {starts_np.shape} != ({pred.shape[0]}, 3)")
    for s, r, d in zip(starts_np.T, importance.shape, acc.shape[:3]):
        if (s < 0).any() or (s + r > d).any():
            raise ValueError("window outside the canvas")
    for t in (acc, pred, importance):
        if not t.is_contiguous():
            raise ValueError("scatter_add_windows needs contiguous tensors")


_MAX_WINDOWS = 32  # csrc/scatter.cu MAX_WINDOWS


def scatter_add_windows(
    acc: torch.Tensor, pred: torch.Tensor, importance: torch.Tensor, starts: Sequence
) -> torch.Tensor:
    """Add ``pred`` (n, rx, ry, rz, C) weighted by ``importance`` (rx, ry, rz)
    and the count lane into ``acc`` (X, Y, Z, C+1) fp32, in place, windows in
    order. ``starts``: (n, 3) host integers. CPU tensors take the plain
    version; CUDA tensors launch ``csrc/scatter.cu``."""
    starts_np = np.ascontiguousarray(np.asarray(starts, np.int32).reshape(-1, 3))
    _check(acc, pred, importance, starts_np)
    if not acc.is_cuda:
        return reference_scatter_add_windows(acc, pred, importance, starts_np)
    if not (pred.is_cuda and importance.is_cuda):
        raise ValueError("acc, pred and importance must be on one CUDA device")
    if torch.is_grad_enabled() and pred.requires_grad:
        raise RuntimeError("scatter_add_windows has no backward")
    fn = kernels.bind(
        "scatter", "scatter_add_windows",
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    )
    X, Y, Z, K = acc.shape
    rx, ry, rz = importance.shape
    stream = kernels.stream_ptr(acc.device)
    item = pred.element_size()
    for lo in range(0, len(starts_np), _MAX_WINDOWS):
        group = np.ascontiguousarray(starts_np[lo : lo + _MAX_WINDOWS])
        err = fn(
            acc.data_ptr(), pred.data_ptr() + lo * pred[0].numel() * item,
            int(pred.dtype == torch.bfloat16), importance.data_ptr(),
            group.ctypes.data, len(group), X, Y, Z, K - 1, rx, ry, rz, stream,
        )
        kernels.check(err, "scatter_add_windows")
        scatter_add_windows.launches += 1
    return acc


scatter_add_windows.launches = 0
