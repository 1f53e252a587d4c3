"""Stride-1 SAME 3^3 convolution to 48 output channels as a hand-written
wgmma implicit GEMM (kernel module K10, ``csrc/conv3x3.cu``).

Replaces no TPU kernel: the JAX package runs these convs on XLA
(``hybrid_ctunet_tpu/ops/conv.py:75``), and the port ran them on cuDNN,
whose kernels at 48 output channels ran far below the card's bf16 rate. The
kernel computes what that direct conv computes: bf16 operands, fp32 sums,
the output rounded to bf16 once. Activations are channels-last (B, X, Y, Z,
C), weights torch's Conv3d layout (48, C, 3, 3, 3), fp32 or bf16.

Backward: through the direct conv (``F.conv3d``, cuDNN), as K9's.
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .recompute import recompute
from .winograd import direct_conv3x3

FEATURES = 48  # the one output width the kernel takes
CINS = (1, 48, 96)  # input widths the gate admits (the kernel takes C 1 and C % 16 == 0)


def supports(x_shape, w_shape, stride, dtype, device) -> bool:
    """Where the kernel engages: a bf16 tensor on a CUDA device, a 3^3
    kernel at stride 1, 48 output channels and C 1, 48 or 96, any extent
    and batch. On the reference models: Swin-UNETR's encoder1, encoder2 and
    the ResBlocks of decoder1 and decoder2 (eight convs a forward), and no
    conv of CTUNet, TUNet or CUNet."""
    return (
        torch.device(device).type == "cuda"
        and dtype == torch.bfloat16
        and len(x_shape) == 5 and len(w_shape) == 5
        and tuple(stride) == (1, 1, 1)
        and tuple(w_shape[2:]) == (3, 3, 3)
        and w_shape[0] == FEATURES
        and x_shape[-1] == w_shape[1] and w_shape[1] in CINS
    )


# the plain version: the direct conv in x's dtype, as ``ops.conv.conv3d_same``
# runs a site that no kernel takes (cuDNN on the channels-last view)
reference_conv3x3 = direct_conv3x3


def packed_elements(cin: int) -> int:
    """bf16 elements of the weight image the first launch writes."""
    return FEATURES * (32 if cin == 1 else 27 * cin)


def conv3x3_call(x: torch.Tensor, w: torch.Tensor):
    """K10's C entry bound to its arguments: ``(fn, args, out, keep)``, where
    ``fn(*args)`` packs w (fp32 or bf16, torch's layout, as the caller holds
    it) into the kernel's bf16 B image by a first launch and runs the conv
    into ``out``; ``keep`` holds the tensors behind the pointers."""
    B, X, Y, Z, C = x.shape
    if not x.is_cuda or x.dtype != torch.bfloat16 or tuple(w.shape) != (FEATURES, C, 3, 3, 3):
        raise ValueError(f"conv3x3 entry: x {tuple(x.shape)} {x.dtype} on {x.device}, "
                         f"w {tuple(w.shape)}: need bf16 CUDA x and w (48, C, 3, 3, 3)")
    x = x.contiguous()
    if x.data_ptr() % 16:  # a view at an odd offset: TMA needs 16-byte alignment
        x = x.clone()
    w = w.contiguous() if w.dtype in (torch.float32, torch.bfloat16) else w.float().contiguous()
    if not w.is_cuda or w.device != x.device:
        raise ValueError("weights must be on the input's CUDA device")
    wp = torch.empty(packed_elements(C), dtype=torch.bfloat16, device=x.device)
    out = torch.empty((B, X, Y, Z, FEATURES), dtype=torch.bfloat16, device=x.device)
    fn = kernels.bind("conv3x3", "conv3x3_48", *[ctypes.c_void_p] * 2, ctypes.c_int,
                      *[ctypes.c_void_p] * 2, *[ctypes.c_int] * 5, ctypes.c_void_p)
    args = (x.data_ptr(), w.data_ptr(), int(w.dtype == torch.bfloat16), wp.data_ptr(),
            out.data_ptr(), B, X, Y, Z, C, kernels.stream_ptr(x.device))
    return fn, args, out, (x, w, wp)


def _launch(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    fn, args, out, _ = conv3x3_call(x, w)
    kernels.check(fn(*args), "conv3x3")
    conv3x3.launches += 1
    return out


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3^3 conv, x (B, X, Y, Z, C) -> (B, X, Y, Z, 48) in x's
    dtype. CPU tensors take the plain version; CUDA tensors launch the
    kernel (the gate's shapes) or raise. Differentiable through the direct
    conv."""
    if tuple(w.shape[1:]) != (x.shape[-1], 3, 3, 3) or x.dim() != 5:
        raise ValueError(f"x {tuple(x.shape)} / w {tuple(w.shape)}: need w (F, C, 3, 3, 3)")
    if not x.is_cuda:
        return reference_conv3x3(x, w)
    if not supports(x.shape, w.shape, (1, 1, 1), x.dtype, x.device):
        raise ValueError(f"conv3x3 kernel: unsupported x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"{x.dtype}")
    return recompute(_launch, reference_conv3x3, x, w)


conv3x3.launches = 0
