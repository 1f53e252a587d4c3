"""3D convolution and transposed convolution with MONAI "SAME" padding,
channels-last in and out. Port of the plain branches of
``hybrid_ctunet_tpu/ops/conv.py`` (``conv3d_same`` :75,
``conv_transpose3d_same`` :413).

The activation stays NDHWC at the function boundary; the conv runs on the
NCDHW view of that memory, which is ``torch.channels_last_3d``, so cuDNN
takes its channels-last path and no copy is made. The JAX package runs these
convs on XLA, not on a kernel of its own, so cuDNN is the counterpart —
except the stride-1 3^3 convs that ``ops.winograd``'s gate takes (K9, where
the JAX hook sits at ``ops/conv.py:100``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import shuffle, winograd


def _triple(v) -> Tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(int(x) for x in v)
    if len(t) == 1:
        return (t[0], t[0], t[0])
    if len(t) != 3:
        raise ValueError(f"expected 3 spatial dims, got {v}")
    return t  # type: ignore[return-value]


def same_padding(kernel_size, stride) -> Tuple[int, int, int]:
    """MONAI's conv padding rule: ``(k - s + 1) // 2`` per axis."""
    k, s = _triple(kernel_size), _triple(stride)
    pads = []
    for ki, si in zip(k, s):
        p = (ki - si + 1) / 2
        if p < 0:
            raise ValueError(
                f"negative SAME padding for kernel={ki}, stride={si}; "
                "change the kernel size and/or stride"
            )
        pads.append(int(p))
    return tuple(pads)  # type: ignore[return-value]


def transpose_output_padding(kernel_size, stride, padding) -> Tuple[int, int, int]:
    """MONAI's transposed-conv output padding: ``2p + s - k`` per axis."""
    k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
    out = []
    for ki, si, pi in zip(k, s, p):
        op = 2 * pi + si - ki
        if op < 0:
            raise ValueError(f"negative output padding for kernel={ki}, stride={si}, padding={pi}")
        out.append(int(op))
    return tuple(out)  # type: ignore[return-value]


def conv3d_same(
    x: torch.Tensor, w: torch.Tensor, stride: Sequence[int] | int = 1
) -> torch.Tensor:
    """Channels-last 3D conv with the reference SAME-padding rule.

    x: (B, X, Y, Z, Cin); w: (Cout, Cin, kx, ky, kz), torch's Conv3d layout
    (the JAX function takes DHWIO). Output (B, X', Y', Z', Cout) in x's dtype
    with X' = floor((X + 2p - k)/s) + 1, p = (k - s + 1)//2. On a CUDA
    tensor that K9's gate admits the conv is K9; elsewhere, the CPU
    included, it is the direct conv (the JAX default, ``WINOGRAD=0``).
    """
    s = _triple(stride)
    if x.is_cuda and winograd.supports(x.shape, w.shape, s, x.dtype):
        return winograd.conv3x3_winograd(x, w)
    p = same_padding(tuple(w.shape[2:]), s)
    xc = x.permute(0, 4, 1, 2, 3)
    wc = w.contiguous(memory_format=torch.channels_last_3d)
    y = F.conv3d(xc, wc, stride=s, padding=p)
    return y.permute(0, 2, 3, 4, 1)


def conv_transpose3d_same(
    x: torch.Tensor, w: torch.Tensor, stride: Sequence[int] | int
) -> torch.Tensor:
    """Channels-last transposed 3D conv reproducing torch ConvTranspose3d with
    MONAI's (padding, output_padding) rule; output spatial = input * stride.

    x: (B, X, Y, Z, Cin); w: (Cin, Cout, kx, ky, kz), torch's ConvTranspose3d
    layout (the JAX function takes (kx, ky, kz, Cin, Cout)), in any float
    dtype: it is cast to x's. Output in x's dtype. kernel == stride (every
    decoder upsample of the reference) is one GEMM Cin -> k^3 Cout with an
    interleaving store: ops.shuffle's K6 where its gate takes the shape, its
    plain version elsewhere. Other kernels go to ``F.conv_transpose3d``.
    """
    s = _triple(stride)
    k = tuple(int(v) for v in w.shape[2:])
    if k == s:
        if shuffle.transp_supports(x.shape, w.shape, x.dtype):
            return shuffle.transp_conv_kxs(x, w, x.dtype)
        return shuffle.reference_transp_conv(x, w, x.dtype)
    p = same_padding(k, s)
    op = transpose_output_padding(k, s, p)
    y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w.to(x.dtype), stride=s, padding=p,
                           output_padding=op)
    return y.permute(0, 2, 3, 4, 1)
