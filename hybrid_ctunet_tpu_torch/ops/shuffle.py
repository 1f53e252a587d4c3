"""The two interleaving GEMMs of ``hybrid_ctunet_tpu/ops/shuffle_pallas.py``.

K5, anisotropic 3D pixel shuffle + per-voxel Linear (``reference_shuffle``,
``fused_pixel_shuffle``): the channel dim splits as (C', f0, f1, f2) with C'
slowest; the factor offsets interleave into space; then Linear(C' -> F) +
bias. ``w`` is in torch's Linear layout (F, C').

K6, the bias-free kernel == stride ConvTranspose3d (``reference_transp_kxs``,
``fused_transp_conv``): one GEMM Cin -> (k0, k1, k2, Cout) per input voxel,
each sub-position's Cout slice stored at (x*k0+i, y*k1+j, z*k2+l). ``w`` is
in torch's ConvTranspose3d layout (Cin, Cout, k0, k1, k2).

Both kernels' backward recomputes through the plain version
(``shuffle_pallas.py:156-177`` and ``:239-266``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import kernels
from .recompute import recompute

_NBLK = 64  # csrc/pixel_shuffle.cu: output features a pass
_T_BN = 128  # csrc/transp_conv.cu: GEMM columns (k0 k1 k2 Cout) per tile
_T_BK = 64  # input channels per stage


def reference_shuffle(x, w, b, factor: Tuple[int, int, int], dtype):
    """Plain version (models/layers.py PixelShuffleLinear default branch)."""
    B, X, Y, Z, C = x.shape
    f0, f1, f2 = factor
    cp = C // (f0 * f1 * f2)
    h = x.reshape(B, X, Y, Z, cp, f0, f1, f2).permute(0, 1, 5, 2, 6, 3, 7, 4)
    h = h.reshape(B, X * f0, Y * f1, Z * f2, cp)
    return torch.matmul(h.to(dtype), w.to(dtype).t()) + b.to(dtype)


def supports(c: int, factor: Tuple[int, int, int], features: int, dtype) -> bool:
    """Where K5 engages: bf16, 4 or 8 sub-positions, C' of 32, 64 or 96 (the
    kernel's instances) and F in passes of 64: every shuffle of the TUNet
    and CTUNet pyramids."""
    div = factor[0] * factor[1] * factor[2]
    return (
        dtype == torch.bfloat16
        and div in (4, 8)
        and c % div == 0
        and c // div in (32, 64, 96)
        and features % _NBLK == 0
    )


def pixel_shuffle_linear(x, w, b, factor: Tuple[int, int, int], dtype):
    """x (B, X, Y, Z, C) -> (B, X*f0, Y*f1, Z*f2, F). CPU tensors take the
    plain version; CUDA tensors launch ``csrc/pixel_shuffle.cu``, differentiable
    through the plain version."""
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
    return recompute(
        lambda x, w, b: _launch_shuffle(x, w, b, (f0, f1, f2), dtype),
        lambda x, w, b: reference_shuffle(x, w, b, factor, dtype),
        x, w, b)


def shuffle_call(x, w, b, factor, dtype):
    """K5's C entry bound to its arguments: ``(fn, args, out, keep)``, where
    ``fn(*args)`` runs the kernel into ``out``. w and b go in as the caller
    holds them, fp32 or bf16 (fp32 where they differ or are another type):
    the kernel rounds them to bf16 as it stages them. ``keep`` holds the
    tensors behind the pointers."""
    B, X, Y, Z, C = x.shape
    f0, f1, f2 = (int(f) for f in factor)
    F, cp = w.shape
    x = x.contiguous()
    wdtype = w.dtype if w.dtype == b.dtype and w.dtype in (torch.float32, torch.bfloat16) \
        else torch.float32
    wk, bk = w.to(wdtype).contiguous(), b.to(wdtype).contiguous()
    if not (wk.is_cuda and bk.is_cuda) or wk.device != x.device or bk.device != x.device:
        raise ValueError("weights must be on the input's CUDA device")
    out = torch.empty((B, X * f0, Y * f1, Z * f2, F), dtype=dtype, device=x.device)
    fn = kernels.bind(
        "pixel_shuffle", "pixel_shuffle_linear",
        *[ctypes.c_void_p] * 3, ctypes.c_int, ctypes.c_void_p, *[ctypes.c_int] * 9,
        ctypes.c_void_p,
    )
    args = (x.data_ptr(), wk.data_ptr(), bk.data_ptr(), int(wdtype == torch.bfloat16),
            out.data_ptr(), B, X, Y, Z, f0, f1, f2, cp, F, kernels.stream_ptr(x.device))
    return fn, args, out, (x, wk, bk)


def _launch_shuffle(x, w, b, factor, dtype):
    fn, args, out, _ = shuffle_call(x, w, b, factor, dtype)
    kernels.check(fn(*args), "pixel_shuffle_linear")
    pixel_shuffle_linear.launches += 1
    return out


pixel_shuffle_linear.launches = 0


def reference_transp_conv(x, w, dtype):
    """Plain version of K6 (the einsum + interleave path of the JAX
    ``conv_transpose3d_same``): x (B, X, Y, Z, Cin), w (Cin, Cout, k0, k1, k2)
    -> (B, X*k0, Y*k1, Z*k2, Cout) in ``dtype``, fp32 sums rounded once."""
    B, X, Y, Z, cin = x.shape
    _, cout, k0, k1, k2 = w.shape
    wm = w.to(dtype).permute(0, 2, 3, 4, 1).reshape(cin, k0 * k1 * k2 * cout)
    y = torch.matmul(x.to(dtype), wm).reshape(B, X, Y, Z, k0, k1, k2, cout)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return y.reshape(B, X * k0, Y * k1, Z * k2, cout)


def transp_supports(x_shape, w_shape, dtype) -> bool:
    """Where K6 engages: bf16, Cin a multiple of the K stage, (k0 k1 k2) Cout
    of the column tile and Cout of 16 bytes — every decoder upsample of
    CUNet and CTUNet (unlike the TPU gate, the small 6x6x12 and 12x12x24
    sites too)."""
    return (
        dtype == torch.bfloat16
        and len(x_shape) == 5 and len(w_shape) == 5
        and w_shape[0] == x_shape[-1]
        and x_shape[-1] % _T_BK == 0
        and w_shape[1] % 8 == 0
        and (w_shape[1] * w_shape[2] * w_shape[3] * w_shape[4]) % _T_BN == 0
    )


def transp_conv_kxs(x, w, dtype):
    """k == s transposed conv, x (B, X, Y, Z, Cin) -> (B, X*k0, Y*k1, Z*k2,
    Cout). CPU tensors take the plain version; CUDA tensors launch
    ``csrc/transp_conv.cu``, differentiable through the plain version."""
    if not x.is_cuda:
        return reference_transp_conv(x, w, dtype)
    if not transp_supports(x.shape, w.shape, dtype):
        raise ValueError(f"transp_conv kernel: unsupported x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"{dtype}")
    if x.dtype != dtype:
        raise TypeError(f"x is {x.dtype}, compute dtype {dtype}")
    return recompute(lambda x, w: _launch_transp(x, w, dtype),
                     lambda x, w: reference_transp_conv(x, w, dtype), x, w)


def transp_call(x, w, dtype):
    """K6's C entry bound to its arguments: ``(fn, args, out, keep)``, where
    ``fn(*args)`` packs w (fp32 or bf16, torch's layout, as the caller holds
    it) into a bf16 scratch by a first launch and runs the GEMM into ``out``;
    ``keep`` holds the tensors behind the pointers."""
    B, X, Y, Z, cin = x.shape
    _, cout, k0, k1, k2 = (int(v) for v in w.shape)
    x = x.contiguous()
    if w.dtype not in (torch.float32, torch.bfloat16):
        w = w.float()
    w = w.contiguous()
    if not w.is_cuda or w.device != x.device:
        raise ValueError("weight must be on the input's CUDA device")
    wp = torch.empty((k0 * k1 * k2 * cout, cin), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((B, X * k0, Y * k1, Z * k2, cout), dtype=dtype, device=x.device)
    fn = kernels.bind(
        "transp_conv", "transp_conv_kxs", ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 9, ctypes.c_void_p,
    )
    args = (x.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16), wp.data_ptr(),
            out.data_ptr(), B, X, Y, Z, k0, k1, k2, cin, cout, kernels.stream_ptr(x.device))
    return fn, args, out, (x, w, wp)


def _launch_transp(x, w, dtype):
    fn, args, out, _ = transp_call(x, w, dtype)
    kernels.check(fn(*args), "transp_conv_kxs")
    transp_conv_kxs.launches += 1
    return out


transp_conv_kxs.launches = 0
