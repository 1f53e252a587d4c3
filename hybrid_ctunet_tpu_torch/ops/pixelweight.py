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


def reference_pixelweight(x1, x2, params: Sequence, dtype, dim_head: int = DIM_HEAD,
                          attn_dropout=None, out_dropout=None):
    """Plain version: x1, x2 (..., C) -> (..., C) in ``dtype``.
    ``attn_dropout`` / ``out_dropout``: callables applied to the
    (..., heads, 2) softmaxed weights in ``dtype`` and to the output
    projection (training only; JAX ``ops/pixelweight.py:55-93``)."""
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
    if attn_dropout is None:
        w1 = (e1 / den).to(dtype)[..., None]
        w2 = (e2 / den).to(dtype)[..., None]
    else:
        w = attn_dropout(torch.stack([e1 / den, e2 / den], dim=-1).to(dtype))
        w1, w2 = w[..., 0:1], w[..., 1:2]
    out = (w1 * v1 + w2 * v2).reshape(shape)
    out = torch.matmul(out, wout.to(dtype).t())
    return out if out_dropout is None else out_dropout(out)


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


def _swizzle(t):
    """(..., R, 64) -> the 128-byte swizzle of csrc/sm90.cuh: the 16-byte
    chunk c of row r stored at chunk c ^ (r % 8)."""
    R = t.shape[-2]
    chunks = t.reshape(*t.shape[:-1], 8, 8)
    idx = torch.arange(8)[None, :] ^ (torch.arange(R) % 8)[:, None]
    return chunks[..., torch.arange(R)[:, None], idx, :].reshape(t.shape)


def pack_weights(wqkv1, wqkv2, wout):
    """Plain version of the C entry's packing launch: the three projections
    as the 1-D bf16 image the kernel streams. Per head pair, per head: one
    entry per 64-wide K block with the head's q, k and v rows of stream 1
    (96 x 64), then stream 2's the same way, or at C >= 256 its q|k rows
    (64 x 64) and then its v rows (32 x 64) in entries of their own; then
    W_out's 64 columns of the pair in 128-row entries. Every entry K-major
    and swizzled."""
    C = wout.shape[0]
    H, KB = C // DIM_HEAD, C // 64

    def per_head(w):  # (3C, C) -> (H, KB, 96, 64)
        w = w.to(torch.bfloat16).reshape(3, H, DIM_HEAD, KB, 64)
        return w.permute(1, 3, 0, 2, 4).reshape(H, KB, 3 * DIM_HEAD, 64)

    s1, s2 = per_head(wqkv1), per_head(wqkv2)
    parts = [s1, s2] if C < 256 else [s1, s2[:, :, :64], s2[:, :, 64:]]
    qkv = torch.cat([_swizzle(t).reshape(H, -1) for t in parts], 1).reshape(H // 2, -1)
    o = wout.to(torch.bfloat16).reshape(C // 128, 128, H // 2, 64).permute(2, 0, 1, 3)
    o = _swizzle(o).reshape(H // 2, -1)
    return torch.cat([qkv, o], 1).reshape(-1)


def _weights(params, device):
    """LN params fp32; the projections as the caller holds them, fp32 or
    bf16 (fp32 where they are mixed or another type): the C entry's packing
    launch reads them, so no torch op runs on parameters already so."""
    ln = [t.float().contiguous() for t in params[:4]]
    w = params[4:]
    wdtype = w[0].dtype
    if wdtype not in (torch.float32, torch.bfloat16) or any(t.dtype != wdtype for t in w):
        wdtype = torch.float32
    w = [t.to(wdtype).contiguous() for t in w]
    if any(not t.is_cuda or t.device != device for t in ln + w):
        raise ValueError("pixelweight parameters must be on the input's CUDA device")
    return ln, w, wdtype


def pixelweight_call(x1, x2, params, dtype):
    """K7's C entry bound to its arguments: ``(fn, args, out, keep)``, where
    ``fn(*args)`` packs the projections (first launch) and runs the kernel
    into ``out`` (x1's shape); ``params`` as the layer holds them. ``keep``
    holds the tensors behind the pointers."""
    C = x1.shape[-1]
    if tuple(params[4].shape) != (3 * C, C) or tuple(params[5].shape) != (3 * C, C) \
            or tuple(params[6].shape) != (C, C):
        raise ValueError("pixelweight weights must be (3C, C), (3C, C), (C, C)")
    a = x1.reshape(-1, C).contiguous()
    b = x2.reshape(-1, C).contiguous()
    ln, w, wdtype = _weights(params, x1.device)
    nbytes = kernels.bind("pixelweight", "pixelweight_packed_bytes", ctypes.c_int)(C)
    packed = torch.empty(nbytes, dtype=torch.uint8, device=x1.device)
    out = torch.empty_like(a)
    fn = kernels.bind(
        "pixelweight", "pixelweight", *[ctypes.c_void_p] * 3, ctypes.c_longlong, ctypes.c_int,
        *[ctypes.c_void_p] * 7, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    )
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], C,
            *[t.data_ptr() for t in ln + w], int(wdtype == torch.bfloat16), packed.data_ptr(),
            kernels.stream_ptr(x1.device))
    return fn, args, out.view(x1.shape), (a, b, ln, w, packed)


def device_pack(wqkv1, wqkv2, wout):
    """The C entry's packing launch alone, on the card: the bf16 image that
    ``pack_weights`` computes in plain torch."""
    C = wout.shape[0]
    ws = [t.contiguous() for t in (wqkv1, wqkv2, wout)]
    if any(t.dtype != ws[0].dtype for t in ws) or ws[0].dtype not in (torch.float32,
                                                                       torch.bfloat16):
        raise TypeError("device_pack takes three fp32 or three bf16 weights")
    packed = torch.empty(7 * C * C, dtype=torch.bfloat16, device=wout.device)
    fn = kernels.bind("pixelweight", "pixelweight_pack", ctypes.c_int, *[ctypes.c_void_p] * 3,
                      ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
    err = fn(C, *[t.data_ptr() for t in ws], int(ws[0].dtype == torch.bfloat16),
             packed.data_ptr(), kernels.stream_ptr(wout.device))
    kernels.check(err, "pixelweight_pack")
    return packed


def _launch(x1, x2, params, dtype):
    fn, args, out, _ = pixelweight_call(x1, x2, params, dtype)
    kernels.check(fn(*args), "pixelweight")
    pixelweight.launches += 1
    return out


pixelweight.launches = 0
