"""Stride-1 SAME 3^3 convolution via Winograd F(2,3)^3 (kernel module K9).
Port of ``hybrid_ctunet_tpu/ops/winograd.py`` (the transforms,
``conv3x3_winograd_reference``) and ``hybrid_ctunet_tpu/ops/winograd_pallas.py``
(``supports``, ``conv3x3_winograd``, ``conv3x3_winograd_fused``).

Per 4^3 input tile d and 3^3 filter g (Lavin & Gray), per axis

    Y = A^T [ (G g G^T) .* (B^T d B) ] A

gives 2^3 outputs from 64 elementwise products; with channels, 64
(tiles x C) @ (C x F) products. Weights are in torch's Conv3d layout
(F, C, 3, 3, 3), as ``ops.conv.conv3d_same`` takes them (the JAX functions
take (3, 3, 3, C, F)). Activations are channels-last (B, X, Y, Z, C).

Rounding points (the kernel's, ``csrc/winograd.cu``): U = G g G^T in fp32,
rounded to the compute dtype; V = B^T d B in fp32 from the compute-dtype
input, rounded; the position products summed in fp32, the inverse
transform in fp32, the output rounded once. In fp32 that is the JAX
reference. The fused form applies the per-(b, c) affine (+ LeakyReLU 0.01)
in fp32 and rounds to the input dtype first (``_apply_affine``), and takes
its InstanceNorm sums over the fp32 output, before the rounding.

Backward: through the direct conv (``F.conv3d``), as the JAX ``_bwd`` and
``_fused_bwd`` do.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from .recompute import recompute

BT = np.array([[1, 0, -1, 0], [0, 1, 1, 0], [0, -1, 1, 0], [0, 1, 0, -1]], np.float32)
G = np.array([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]], np.float32)
AT = np.array([[1, 1, 1, 0], [0, 1, -1, -1]], np.float32)

CIN = 32  # the one input width the kernel takes (the JAX WINOGRAD_CH default)
FEATURES = (32, 64, 128)
_TB = (2, 4, 4)  # csrc/winograd.cu TBX, TBY, TBZ: 2x2x2-output tiles per work item
SLOPE = 0.01
_MATS = {"BT": BT, "AT": AT, "GGG": np.kron(np.kron(G, G), G)}  # GGG: (64, 27)


@functools.lru_cache(maxsize=None)
def _mat(name: str, device: torch.device) -> torch.Tensor:
    """A transform matrix on ``device``, copied there once: a copy from the
    host waits for the device's queue, which would stall every call. Made
    outside inference mode, so that autograd may save it."""
    with torch.inference_mode(False):
        return torch.tensor(_MATS[name], dtype=torch.float32, device=device)


def transform_filter(w: torch.Tensor) -> torch.Tensor:
    """w (F, C, 3, 3, 3) -> U (4, 4, 4, C, F), fp32: one product with
    G (x) G (x) G, whose entries are products of 0, +-1/2 and 1."""
    Fo, C = w.shape[:2]
    taps = w.float().permute(2, 3, 4, 1, 0).reshape(27, C * Fo)
    return (_mat("GGG", w.device) @ taps).reshape(4, 4, 4, C, Fo)


def _winograd_fp32(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """The F(2,3)^3 conv of x (B, X, Y, Z, C) with w (F, C, 3, 3, 3), fp32
    out; V and U rounded to ``dtype``."""
    B, X, Y, Z, _ = x.shape
    bt, at = _mat("BT", x.device), _mat("AT", x.device)
    xp = F.pad(x.to(dtype).float(), (0, 0, 1, 1, 1, 1, 1, 1))
    t = xp.unfold(1, 4, 2).unfold(2, 4, 2).unfold(3, 4, 2)  # (B, tx, ty, tz, C, 4, 4, 4)
    v = torch.einsum("ai,bj,ck,ntuvqijk->ntuvabcq", bt, bt, bt, t).to(dtype).float()
    u = transform_filter(w).to(dtype).float()
    m = torch.einsum("ntuvabcq,abcqf->ntuvabcf", v, u)
    y = torch.einsum("oa,pb,rc,ntuvabcf->ntuvoprf", at, at, at, m)
    return y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, X, Y, Z, w.shape[0])


def reference_conv3x3_winograd(x: torch.Tensor, w: torch.Tensor, dtype=None) -> torch.Tensor:
    """Plain version of K9 (``conv3x3_winograd_reference``), out in
    ``dtype`` (default x's): x (B, X, Y, Z, C) with X, Y, Z even, w
    (F, C, 3, 3, 3)."""
    dtype = x.dtype if dtype is None else dtype
    return _winograd_fp32(x, w, dtype).to(dtype)


def apply_affine(x, scale, bias, act: bool):
    """The previous InstanceNorm's normalize (+ LeakyReLU) on the conv input
    (``_apply_affine``): scale, bias (B, C) fp32; fp32 math, x's dtype out."""
    t = x.float() * scale[:, None, None, None, :] + bias[:, None, None, None, :]
    if act:
        t = torch.where(t > 0, t, SLOPE * t)
    return t.to(x.dtype)


def _stats(yf: torch.Tensor):
    return yf.sum(dim=(1, 2, 3)), yf.square().sum(dim=(1, 2, 3))


def reference_conv3x3_winograd_fused(x, w, scale=None, bias=None, act: bool = False,
                                     emit_stats: bool = False):
    """Plain version of the fused form: [affine (+ LeakyReLU)] -> F(2,3)^3
    conv in x's dtype [-> per-(b, f) sums of y and y^2 over space, fp32,
    from the unrounded output]."""
    xe = apply_affine(x, scale, bias, act) if scale is not None else x
    yf = _winograd_fp32(xe, w, x.dtype)
    y = yf.to(x.dtype)
    return (y, *_stats(yf)) if emit_stats else y


def direct_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The direct SAME conv in x's dtype (``_direct_conv``): the backward's
    path, cuDNN on the channels-last view as in ``ops.conv.conv3d_same``."""
    wc = w.to(x.dtype).contiguous(memory_format=torch.channels_last_3d)
    return F.conv3d(x.permute(0, 4, 1, 2, 3), wc, padding=1).permute(0, 2, 3, 4, 1)


def direct_conv3x3_fused(x, w, scale=None, bias=None, act: bool = False,
                         emit_stats: bool = False):
    """``_fused_ref``: the fused op through the direct conv, its sums over
    the rounded output. The fused form's backward differentiates this."""
    xe = apply_affine(x, scale, bias, act) if scale is not None else x
    y = direct_conv3x3(xe, w)
    return (y, *_stats(y.float())) if emit_stats else y


def supports(x_shape, w_shape, stride, dtype) -> bool:
    """Where the kernel engages: bf16, stride 1, 3^3, Cin 32, F 32/64/128 and
    even spatial dims (the JAX gate less its TPU tile rules). On the
    reference models: the ResNet's stage-1 bottleneck conv2, 32 -> 32 at
    48x48x96 for 96^3 windows, 8 calls a ResNet-101 forward."""
    return (
        dtype == torch.bfloat16
        and len(x_shape) == 5 and len(w_shape) == 5
        and tuple(stride) == (1, 1, 1)
        and tuple(w_shape[2:]) == (3, 3, 3)
        and x_shape[-1] == CIN and w_shape[1] == CIN
        and w_shape[0] in FEATURES
        and all(d % 2 == 0 for d in x_shape[1:4])
    )


def num_blocks(X: int, Y: int, Z: int) -> int:
    """Work items (blocks of 2x4x4 tiles) of one sample and 32 features."""
    return math.prod(-(-(d // 2) // tb) for d, tb in zip((X, Y, Z), _TB))


def _launch(x, w, scale, bias, act: bool, emit_stats: bool):
    """K9 on CUDA tensors, one entry of ``csrc/winograd.cu``: a first launch
    forms U in fp32 from w and rounds it to bf16 into a (64, F, C) buffer
    (``transform_filter``'s sum, in the layout of the kernel's B operand);
    the second runs the transforms and products; with ``emit_stats`` a third
    combines the per-item sums in a fixed order."""
    B, X, Y, Z, C = x.shape
    Fo = w.shape[0]
    x = x.contiguous()
    w = w.contiguous() if w.dtype in (torch.float32, torch.bfloat16) else w.float().contiguous()
    u = torch.empty((64, Fo, C), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((B, X, Y, Z, Fo), dtype=torch.bfloat16, device=x.device)
    work = None
    if emit_stats:
        work = torch.empty(B * num_blocks(X, Y, Z) * 2 * Fo + B * 2 * Fo, dtype=torch.float32,
                           device=x.device)
    sc = bi = None
    if scale is not None:
        sc, bi = scale.float().contiguous(), bias.float().contiguous()
        if tuple(sc.shape) != (B, C) or tuple(bi.shape) != (B, C):
            raise ValueError(f"affine scale/bias must be ({B}, {C})")
    if any(t is not None and (not t.is_cuda or t.device != x.device) for t in (w, sc, bi)):
        raise ValueError("weights and affine must be on the input's CUDA device")
    fn = kernels.bind(
        "winograd", "conv3x3_winograd", *[ctypes.c_void_p] * 2, ctypes.c_int,
        *[ctypes.c_void_p] * 4, ctypes.c_int, ctypes.c_void_p, *[ctypes.c_int] * 5,
        ctypes.c_void_p,
    )
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(x.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16), u.data_ptr(),
             out.data_ptr(), ptr(sc), ptr(bi), int(act), ptr(work), B, X, Y, Z, Fo,
             kernels.stream_ptr(x.device))
    kernels.check(err, "conv3x3_winograd")
    conv3x3_winograd.launches += 1
    if not emit_stats:
        return out
    st = work[-B * 2 * Fo:].view(B, 2, Fo)
    return out, st[:, 0].clone(), st[:, 1].clone()


def _check(x, w):
    if not supports(x.shape, w.shape, (1, 1, 1), x.dtype) and x.is_cuda:
        raise ValueError(f"conv3x3_winograd kernel: unsupported x {tuple(x.shape)} "
                         f"w {tuple(w.shape)} {x.dtype}")
    if tuple(w.shape[1:]) != (x.shape[-1], 3, 3, 3) or any(d % 2 for d in x.shape[1:4]):
        raise ValueError(f"x {tuple(x.shape)} / w {tuple(w.shape)}: need w (F, C, 3, 3, 3) "
                         "and even spatial dims")


def conv3x3_winograd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3^3 conv, x (B, X, Y, Z, C) -> (B, X, Y, Z, F) in x's
    dtype. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/winograd.cu`` (bf16, the gate's shapes) or raise. Differentiable
    through the direct conv."""
    _check(x, w)
    if x.is_cuda:
        run = lambda xx, ww: _launch(xx, ww, None, None, False, False)
    else:
        run = reference_conv3x3_winograd
    return recompute(run, direct_conv3x3, x, w)


conv3x3_winograd.launches = 0


def conv3x3_winograd_fused(x, w, in_affine=None, *, in_act: bool = False,
                           emit_stats: bool = False):
    """The fused-chain form: ``in_affine`` (scale, bias), each (B, C) fp32 —
    the previous InstanceNorm's normalize, + LeakyReLU with ``in_act`` —
    applied to x on load; with ``emit_stats`` also (s1, s2), each (B, F)
    fp32 sums of y and y^2 over space. Same kernel (counted on
    ``conv3x3_winograd``); differentiable through ``direct_conv3x3_fused``."""
    _check(x, w)
    if in_affine is None:
        tensors, act = (x, w), False
    else:
        tensors, act = (x, w, *in_affine), in_act

    def plain(xx, ww, sc=None, bi=None):
        return reference_conv3x3_winograd_fused(xx, ww, sc, bi, act, emit_stats)

    def run(xx, ww, sc=None, bi=None):
        return _launch(xx, ww, sc, bi, act, emit_stats)

    def backward(xx, ww, sc=None, bi=None):
        return direct_conv3x3_fused(xx, ww, sc, bi, act, emit_stats)

    return recompute(run if x.is_cuda else plain, backward, *tensors)
