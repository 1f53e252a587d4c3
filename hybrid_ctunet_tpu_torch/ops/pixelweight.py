"""Binary cross-weight ("pixelweight") fusion of two same-shape streams
(kernel module K7). Port of ``hybrid_ctunet_tpu/ops/pixelweight.py``.

Per token and head: LayerNorm each stream, bias-free QKV per stream, scalar
cross-dots <q2, k1> and <q1, k2> scaled by dim_head^-0.5, softmax over the
two, ``w1 v1 + w2 v2``, bias-free output projection (reference
hybrid_CTUNet.py:622-669). ``params`` is ``(ln1_w, ln1_b, ln2_w, ln2_b,
wqkv1, wqkv2, wout)`` with the projections in torch's Linear layout
(3C, C), (3C, C), (C, C).

Rounding points are ``pixelweight_reference``'s (the JAX CPU path): LN
output and q/k/v rounded to the compute dtype, each q2*k1 product rounded
before the fp32 head sum, softmax weights rounded, the blend in the compute
dtype. The TPU's Pallas kernel kept LN, q/k/v and the blend in fp32. The
backward recomputes through the plain version (``pixelweight.py:177-197``).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from .. import kernels
from .recompute import recompute

DIM_HEAD = 32


def reference_pixelweight(x1, x2, params: Sequence, dtype, dim_head: int = DIM_HEAD):
    """Plain version: x1, x2 (..., C) -> (..., C) in ``dtype``."""
    ln1w, ln1b, ln2w, ln2b, wqkv1, wqkv2, wout = params
    shape = x1.shape
    C = shape[-1]
    heads = C // dim_head

    def ln(x, w, b):
        return F.layer_norm(x.float(), (C,), w.float(), b.float(), 1e-5).to(dtype)

    qkv1 = torch.matmul(ln(x1, ln1w, ln1b), wqkv1.to(dtype).t())
    qkv2 = torch.matmul(ln(x2, ln2w, ln2b), wqkv2.to(dtype).t())
    q1, k1, v1 = (t.reshape(*shape[:-1], heads, dim_head) for t in qkv1.split(C, dim=-1))
    q2, k2, v2 = (t.reshape(*shape[:-1], heads, dim_head) for t in qkv2.split(C, dim=-1))
    scale = dim_head ** -0.5
    d1 = (q2 * k1).float().sum(-1) * scale
    d2 = (q1 * k2).float().sum(-1) * scale
    m = torch.maximum(d1, d2)
    e1, e2 = torch.exp(d1 - m), torch.exp(d2 - m)
    den = e1 + e2
    w1 = (e1 / den).to(dtype)[..., None]
    w2 = (e2 / den).to(dtype)[..., None]
    out = (w1 * v1 + w2 * v2).reshape(shape)
    return torch.matmul(out, wout.to(dtype).t())


def supports(c: int, dtype, dim_head: int = DIM_HEAD) -> bool:
    """Where the kernel engages: bf16 at the fusion decoder's widths."""
    return dtype == torch.bfloat16 and c in (128, 256, 512) and dim_head == DIM_HEAD


def pixelweight(x1, x2, params: Sequence, dtype, dim_head: int = DIM_HEAD):
    """x1, x2 (..., C) -> (..., C). CPU tensors take the plain version; CUDA
    tensors launch ``csrc/pixelweight.cu``, differentiable through the plain
    version."""
    if not x1.is_cuda:
        return reference_pixelweight(x1, x2, params, dtype, dim_head)
    C = x1.shape[-1]
    if x1.shape != x2.shape or not supports(C, dtype, dim_head):
        raise ValueError(f"pixelweight kernel: unsupported {tuple(x1.shape)} / "
                         f"{tuple(x2.shape)} dim_head={dim_head} {dtype}")
    if x1.dtype != dtype or x2.dtype != dtype:
        raise TypeError(f"inputs are {x1.dtype}/{x2.dtype}, compute dtype {dtype}")
    return recompute(
        lambda x1, x2, *p: _launch(x1, x2, p, dtype),
        lambda x1, x2, *p: reference_pixelweight(x1, x2, p, dtype, dim_head),
        x1, x2, *params)


def _launch(x1, x2, params, dtype):
    C = x1.shape[-1]
    ln1w, ln1b, ln2w, ln2b, wqkv1, wqkv2, wout = params
    if tuple(wqkv1.shape) != (3 * C, C) or tuple(wqkv2.shape) != (3 * C, C) \
            or tuple(wout.shape) != (C, C):
        raise ValueError("pixelweight weights must be (3C, C), (3C, C), (C, C)")
    a = x1.reshape(-1, C).contiguous()
    b = x2.reshape(-1, C).contiguous()
    ps = [t.float().contiguous() for t in (ln1w, ln1b, ln2w, ln2b)]
    ps += [t.to(dtype).contiguous() for t in (wqkv1, wqkv2, wout)]
    if any(not t.is_cuda or t.device != x1.device for t in ps):
        raise ValueError("pixelweight parameters must be on the input's CUDA device")
    out = torch.empty_like(a)
    fn = kernels.bind(
        "pixelweight", "pixelweight", *[ctypes.c_void_p] * 3, ctypes.c_longlong, ctypes.c_int,
        *[ctypes.c_void_p] * 8,
    )
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], C,
             *[t.data_ptr() for t in ps], kernels.stream_ptr(x1.device))
    kernels.check(err, "pixelweight")
    pixelweight.launches += 1
    return out.reshape(x1.shape)


pixelweight.launches = 0
