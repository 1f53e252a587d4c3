"""Windowed multi-head attention with a 3D relative-position bias (kernel
module K2). Port of ``hybrid_ctunet_tpu/ops/attention_pallas.py`` and of the
bias gather in front of it (``models/layers.py`` MultiAxisWindowAttention).

The QKV and output projections and the window partition stay in plain
PyTorch (models/layers.py); the kernel computes per window and head
``softmax(q k^T + bias) v`` with q pre-scaled, fp32 scores and softmax, and
the probabilities cast to the compute dtype before the PV product. It takes
the layer's ((2w-1)^3, heads) bias table and computes each score's index
into it (``rel_pos_index``) instead of reading a gathered (heads, T, T)
bias. The backward recomputes through the plain version
(``attention_pallas.py:92-106``), so the gradient reaches the table through
the gather.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels
from .recompute import recompute

_DH = 32  # csrc/window_attention.cu DH
_WMAX = 6  # csrc/window_attention.cu WMAX: windows up to 6^3 = 216 tokens
_TOKENS = frozenset(w ** 3 for w in range(1, _WMAX + 1))


@functools.lru_cache(maxsize=None)
def rel_pos_index(window: int, device=None) -> torch.Tensor:
    """(w^3, w^3) int64 index into the ((2w-1)^3, heads) table, tokens in
    (h, w, f) order: sum over axes of (p_i - p_j + w - 1) * stride, computed
    as the kernel does, a row term of p_i plus a column term of p_j. Cached
    per device (made outside inference mode, so autograd may save it)."""
    w, s = window, 2 * window - 1
    with torch.inference_mode(False):
        pos = torch.arange(w ** 3, device=device)
        a, b, c = pos // (w * w), (pos // w) % w, pos % w
        row = ((a + w - 1) * s + b + w - 1) * s + c + w - 1
        col = (a * s + b) * s + c
        return row[:, None] - col[None, :]


def gather_bias(table: torch.Tensor, window: int) -> torch.Tensor:
    """The (heads, T, T) fp32 bias of a ((2w-1)^3, heads) table."""
    return table.float()[rel_pos_index(window, table.device)].permute(2, 0, 1)


def reference_window_attention(q, k, v, bias, dtype, attn_dropout=None):
    """Plain core. q (pre-scaled), k, v: (n, T, heads*dh); bias
    (heads, T, T) fp32. Products of the compute-dtype inputs are summed in
    fp32 (the inputs are upcast, which is exact), as the JAX oracle's
    ``preferred_element_type=float32``. ``attn_dropout``: a callable
    applied to the softmaxed scores in the compute dtype (training only)."""
    n, t, c = q.shape
    heads = bias.shape[0]
    dh = c // heads

    def split(x):
        return x.reshape(n, t, heads, dh).transpose(1, 2).float()

    qh, kh, vh = split(q), split(k), split(v)
    sim = torch.matmul(qh, kh.transpose(-1, -2)) + bias.float()[None]
    attn = torch.softmax(sim, dim=-1).to(dtype)
    if attn_dropout is not None:
        attn = attn_dropout(attn)
    out = torch.matmul(attn.float(), vh).to(dtype)
    return out.transpose(1, 2).reshape(n, t, c)


def reference_window_attention_table(q, k, v, table, window: int, dtype, attn_dropout=None):
    """Plain version of K2: the table gathered to (heads, T, T), then the
    plain core."""
    return reference_window_attention(q, k, v, gather_bias(table, window), dtype, attn_dropout)


def supports(t: int, c: int, heads: int, dtype) -> bool:
    """Shapes the kernel takes: bf16, head width 32, windows of w^3 tokens
    with w <= 6."""
    return dtype == torch.bfloat16 and c == heads * _DH and t in _TOKENS


def _ld(x: torch.Tensor) -> int:
    """Row stride of an (n, T, C) view whose rows may be strided."""
    n, t, c = x.shape
    if x.stride(2) != 1 or x.stride(0) != t * x.stride(1) or x.stride(1) % 8:
        raise ValueError(f"unsupported layout: shape {tuple(x.shape)} strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("window_attention needs 16-byte aligned rows")
    return x.stride(1)


def window_attention(q, k, v, table, window: int, dtype):
    """q (pre-scaled), k, v: (n_windows, w^3, heads*dh) in ``dtype``, rows
    may be strided views of one qkv tensor; table: ((2w-1)^3, heads) fp32,
    the layer's ``rel_pos_bias.weight``. Returns (n_windows, w^3, heads*dh)
    in ``dtype``. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/window_attention.cu``, differentiable through the plain version."""
    if not q.is_cuda:
        return reference_window_attention_table(q, k, v, table, window, dtype)
    n, t, c = q.shape
    heads = table.shape[-1]
    if t != window ** 3 or not supports(t, c, heads, dtype):
        raise ValueError(f"window_attention kernel: unsupported T={t} window={window} C={c} "
                         f"heads={heads} {dtype}")
    if any(x.dtype != dtype or x.shape != q.shape or not x.is_cuda for x in (q, k, v)):
        raise ValueError("q, k, v must share shape, dtype and a CUDA device")
    if table.dtype != torch.float32 or tuple(table.shape) != ((2 * window - 1) ** 3, heads) \
            or table.device != q.device:
        raise ValueError(f"table must be float32 ({(2 * window - 1) ** 3}, {heads}) on q's device")
    return recompute(
        lambda q, k, v, table: _launch(q, k, v, table, window, dtype),
        lambda q, k, v, table: reference_window_attention_table(q, k, v, table, window, dtype),
        q, k, v, table)


def _launch(q, k, v, table, window, dtype):
    n, t, c = q.shape
    table = table.contiguous()
    out = torch.empty((n, t, c), dtype=dtype, device=q.device)
    fn = kernels.bind(
        "window_attention", "window_attention",
        *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 7, ctypes.c_void_p,
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(), out.data_ptr(),
        n, window, table.shape[1], _ld(q), _ld(k), _ld(v), c, kernels.stream_ptr(q.device),
    )
    kernels.check(err, "window_attention")
    window_attention.launches += 1
    return out


window_attention.launches = 0
