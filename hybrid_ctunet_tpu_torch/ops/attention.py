"""Windowed multi-head attention with relative-position bias (kernel module
K2). Port of ``hybrid_ctunet_tpu/ops/attention_pallas.py``.

The QKV and output projections and the window partition stay in plain
PyTorch (models/layers.py); the kernel computes per window and head
``softmax(q k^T + bias) v`` with q pre-scaled, fp32 scores and softmax, and
the probabilities cast to the compute dtype before the PV product. The
backward recomputes through the plain version (``attention_pallas.py:92-106``).
"""
from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .recompute import recompute

_DH = 32  # csrc/window_attention.cu DH
_TMAX = 224  # csrc/window_attention.cu TP


def reference_window_attention(q, k, v, bias, dtype):
    """Plain version. q (pre-scaled), k, v: (n, T, heads*dh); bias
    (heads, T, T) fp32. Products of the compute-dtype inputs are summed in
    fp32 (the inputs are upcast, which is exact), as the JAX oracle's
    ``preferred_element_type=float32``."""
    n, t, c = q.shape
    heads = bias.shape[0]
    dh = c // heads

    def split(x):
        return x.reshape(n, t, heads, dh).transpose(1, 2).float()

    qh, kh, vh = split(q), split(k), split(v)
    sim = torch.matmul(qh, kh.transpose(-1, -2)) + bias.float()[None]
    attn = torch.softmax(sim, dim=-1).to(dtype)
    out = torch.matmul(attn.float(), vh).to(dtype)
    return out.transpose(1, 2).reshape(n, t, c)


def supports(t: int, c: int, heads: int, dtype) -> bool:
    """Shapes the kernel takes: bf16, head width 32, at most 224 tokens."""
    return dtype == torch.bfloat16 and c == heads * _DH and 1 <= t <= _TMAX


def _ld(x: torch.Tensor) -> int:
    """Row stride of an (n, T, C) view whose rows may be strided."""
    n, t, c = x.shape
    if x.stride(2) != 1 or x.stride(0) != t * x.stride(1) or x.stride(1) % 8:
        raise ValueError(f"unsupported layout: shape {tuple(x.shape)} strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("window_attention needs 16-byte aligned rows")
    return x.stride(1)


def window_attention(q, k, v, bias, dtype):
    """q (pre-scaled), k, v: (n_windows, T, heads*dh) in ``dtype``, rows may
    be strided views of one qkv tensor; bias: (heads, T, T) fp32. Returns
    (n_windows, T, heads*dh) in ``dtype``. CPU tensors take the plain version;
    CUDA tensors launch ``csrc/window_attention.cu``, differentiable through
    the plain version."""
    if not q.is_cuda:
        return reference_window_attention(q, k, v, bias, dtype)
    n, t, c = q.shape
    heads = bias.shape[0]
    if not supports(t, c, heads, dtype):
        raise ValueError(f"window_attention kernel: unsupported T={t} C={c} heads={heads} {dtype}")
    if any(x.dtype != dtype or x.shape != q.shape or not x.is_cuda for x in (q, k, v)):
        raise ValueError("q, k, v must share shape, dtype and a CUDA device")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (heads, t, t):
        raise ValueError(f"bias must be float32 ({heads}, {t}, {t})")
    return recompute(
        lambda q, k, v, bias: _launch(q, k, v, bias, heads, dtype),
        lambda q, k, v, bias: reference_window_attention(q, k, v, bias, dtype),
        q, k, v, bias)


def _launch(q, k, v, bias, heads, dtype):
    n, t, c = q.shape
    bias = bias.contiguous()
    out = torch.empty((n, t, c), dtype=dtype, device=q.device)
    fn = kernels.bind(
        "window_attention", "window_attention",
        *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 7, ctypes.c_void_p,
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
        n, t, heads, _ld(q), _ld(k), _ld(v), c, kernels.stream_ptr(q.device),
    )
    kernels.check(err, "window_attention")
    window_attention.launches += 1
    return out


window_attention.launches = 0
