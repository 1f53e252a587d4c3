"""Transformer FeedForward: LN -> fc1 -> erf-GELU -> fc2 (kernel modules K3
and K4). Port of ``hybrid_ctunet_tpu/ops/ffn_pallas.py``.

Weights are in torch's Linear layout: ``w1`` (H, C), ``w2`` (C, H). Rounding
points (the JAX ``reference_ffn``): fp32 LN (eps 1e-5) rounded to x's dtype;
each matmul sums in fp32 and is rounded to the compute dtype before its
bias, cast to the compute dtype, is added; GELU runs on the rounded value.
``F.linear(x, w, b)`` would add the bias before rounding, so it is not used.
Both kernels' backward recomputes through the plain version
(``ffn_pallas.py:177-201`` and ``:253-274``).
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .. import kernels
from .act import gelu_exact
from .norm import layer_norm
from .recompute import recompute

_HC = 64  # csrc/ffn.cu HC: hidden chunk


def _linear(x: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """x @ w^T in ``dtype``, fp32 accumulation, one rounding."""
    return torch.matmul(x.to(dtype), w.to(dtype).t())


def reference_ffn(x, ln_w, ln_b, w1, b1, w2, b2, dtype, hidden_dropout=None, out_dropout=None):
    """Plain version: FFN(x) without the residual. ``hidden_dropout`` /
    ``out_dropout``: callables applied after the GELU and after fc2
    (training only; JAX ``models/layers.py:287-299``)."""
    y = layer_norm(x, ln_w, ln_b)
    h = _linear(y, w1, dtype) + b1.to(dtype)
    h = gelu_exact(h)
    if hidden_dropout is not None:
        h = hidden_dropout(h)
    out = _linear(h, w2, dtype) + b2.to(dtype)
    return out if out_dropout is None else out_dropout(out)


def reference_ffn_pair(x, params1: Sequence, params2: Sequence, dtype):
    """Plain version of the pair: y = x + FFN1(x); z = y + FFN2(y)."""
    y = x + reference_ffn(x, *params1, dtype)
    return y + reference_ffn(y, *params2, dtype)


def supports(c: int, hidden: int, dtype) -> bool:
    """Where the single-FFN kernel (K3) engages, as in the JAX package: bf16
    pyramid FFNs with hidden <= 1024 (C 256 at stage 2; stage 3's pair is
    K4, ``pair_supports``). The ViT FFN and stages 0-1 stay plain."""
    return dtype == torch.bfloat16 and c in (128, 256) and hidden % _HC == 0 and 0 < hidden <= 1024


def _weights(params_list: Sequence[Sequence], c: int, hidden: int, device):
    """The FFNs' parameters as the C entries take them: LN scale and shift
    fp32; weights and biases as the caller holds them, fp32 or bf16 (fp32
    where they are mixed or another type). No torch op runs on parameters
    that are already so: the entry's first launch packs them."""
    weights = [t for p in params_list for t in p[2:]]
    wdtype = weights[0].dtype
    if wdtype not in (torch.float32, torch.bfloat16) or any(t.dtype != wdtype for t in weights):
        wdtype = torch.float32
    prepared = []
    for ln_w, ln_b, w1, b1, w2, b2 in params_list:
        if tuple(w1.shape) != (hidden, c) or tuple(w2.shape) != (c, hidden):
            raise ValueError(f"fc1 {tuple(w1.shape)} / fc2 {tuple(w2.shape)} do not match "
                             f"C={c} hidden={hidden}")
        prepared += [ln_w.float().contiguous(), ln_b.float().contiguous(),
                     *[t.to(wdtype).contiguous() for t in (w1, b1, w2, b2)]]
    if any(not t.is_cuda or t.device != device for t in prepared):
        raise ValueError("ffn parameters must be on the input's CUDA device")
    return prepared, wdtype


def ffn(x, ln_w, ln_b, w1, b1, w2, b2, dtype, residual: bool = False):
    """x (..., C) -> FFN(x), or x + FFN(x) with ``residual``. CPU tensors take
    the plain version; CUDA tensors launch ``csrc/ffn.cu``, differentiable
    through the plain version."""
    def plain(x, *p):
        out = reference_ffn(x, *p, dtype)
        return x + out if residual else out

    if not x.is_cuda:
        return plain(x, ln_w, ln_b, w1, b1, w2, b2)
    return recompute(lambda x, *p: _launch_ffn(x, p, dtype, residual), plain,
                     x, ln_w, ln_b, w1, b1, w2, b2)


def ffn_call(x, params: Sequence, dtype, residual: bool = False):
    """K3's C entry bound to its arguments: ``(fn, args, out, keep)``, where
    ``fn(*args)`` packs the weights (first launch) and runs the kernel into
    ``out`` (x's shape); ``params`` is ``(ln_w, ln_b, w1, b1, w2, b2)`` as the
    layer holds them. ``keep`` holds the tensors behind the pointers."""
    if x.dtype != dtype:
        raise TypeError(f"x is {x.dtype}, compute dtype {dtype}")
    c, hidden = x.shape[-1], params[2].shape[0]
    if not supports(c, hidden, dtype):
        raise ValueError(f"ffn kernel: unsupported C={c} hidden={hidden} {dtype}")
    prepared, wdtype = _weights([params], c, hidden, x.device)
    x2d = x.reshape(-1, c).contiguous()
    out = torch.empty_like(x2d)
    nbytes = kernels.bind("ffn", "ffn_packed_bytes", ctypes.c_int, ctypes.c_int)(c, hidden)
    packed = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    fn = kernels.bind(
        "ffn", "ffn", ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 8,
    )
    args = (x2d.data_ptr(), out.data_ptr(), x2d.shape[0], c, hidden, int(residual),
            int(wdtype == torch.bfloat16), *[t.data_ptr() for t in prepared],
            packed.data_ptr(), kernels.stream_ptr(x.device))
    return fn, args, out.view(x.shape), (x2d, prepared, packed)


def _launch_ffn(x, params, dtype, residual):
    fn, args, out, _ = ffn_call(x, params, dtype, residual)
    kernels.check(fn(*args), "ffn")
    ffn.launches += 1
    return out


ffn.launches = 0


def pair_supports(c: int, hidden: int, dtype) -> bool:
    """Where the pair kernel engages: the bf16 stage-3 pair of the decoder
    pyramid (C 128) with a hidden width of 64-chunks up to 1024."""
    return dtype == torch.bfloat16 and c == 128 and hidden % _HC == 0 and 0 < hidden <= 1024


def ffn_pair(x, params1: Sequence, params2: Sequence, dtype):
    """``z = y + FFN2(y)`` with ``y = x + FFN1(x)``; ``params*`` are
    ``(ln_w, ln_b, w1, b1, w2, b2)``. CPU tensors take the plain version; CUDA
    tensors launch ``csrc/ffn.cu`` with y kept on chip."""
    if not x.is_cuda:
        return reference_ffn_pair(x, params1, params2, dtype)
    n = len(params1)
    return recompute(
        lambda x, *p: _launch_pair(x, p[:n], p[n:], dtype),
        lambda x, *p: reference_ffn_pair(x, p[:n], p[n:], dtype),
        x, *params1, *params2)


def pair_call(x, params1: Sequence, params2: Sequence, dtype):
    """The pair's C entry bound to its arguments: ``(fn, args, out, keep)``,
    where ``fn(*args)`` packs the weights (first launch) and runs the kernel into
    ``out`` (x's shape). The weights go in as the caller holds them (fp32 or
    bf16, torch layout): the packing is the entry's own launch. ``keep`` holds
    the tensors behind the pointers."""
    if x.dtype != dtype:
        raise TypeError(f"x is {x.dtype}, compute dtype {dtype}")
    c, hidden = x.shape[-1], params1[2].shape[0]
    if not pair_supports(c, hidden, dtype):
        raise ValueError(f"ffn_pair kernel: unsupported C={c} hidden={hidden} {dtype}")
    prepared, wdtype = _weights([params1, params2], c, hidden, x.device)
    x2d = x.reshape(-1, c).contiguous()
    out = torch.empty_like(x2d)
    nbytes = kernels.bind("ffn", "ffn_pair_packed_bytes", ctypes.c_int)(hidden)
    packed = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
    fn = kernels.bind(
        "ffn", "ffn_pair", ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, *[ctypes.c_void_p] * 14,
    )
    args = (x2d.data_ptr(), out.data_ptr(), x2d.shape[0], c, hidden,
            int(wdtype == torch.bfloat16), *[t.data_ptr() for t in prepared],
            packed.data_ptr(), kernels.stream_ptr(x.device))
    return fn, args, out.view(x.shape), (x2d, prepared, packed)


def _launch_pair(x, params1, params2, dtype):
    fn, args, out, _ = pair_call(x, params1, params2, dtype)
    kernels.check(fn(*args), "ffn_pair")
    ffn_pair.launches += 1
    return out


ffn_pair.launches = 0
