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

Two instances of the kernel: head width 32 over windows of w^3 <= 216
tokens (TUNet and CTUNet), and head width 16 over Swin-UNETR's 7^3 windows
(and its 6^3 windows at a 6^3 map, indexed over a 7^3 layout: the
``index_window``), with the shifted blocks' region mask (``shift``)
computed in the kernel from each token's place in the padded grid.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .. import kernels
from .recompute import recompute

# csrc/window_attention.cu's instances: head width -> (largest window edge,
# index windows taken); the width-16 instance takes Swin-UNETR's 7^3 windows
# and its 6^3 windows indexed over a 7^3 layout
_INSTANCES = {32: (6, None), 16: (7, 7)}
MASK_VALUE = -100.0  # a shifted window's score between two regions (Swin's)


@functools.lru_cache(maxsize=None)
def rel_pos_index(window, device=None, index_window=None) -> torch.Tensor:
    """(T, T) int64 index into the ((2v-1)^3, heads) table for windows of
    T = w^3 tokens (``window`` w, or (wx, wy, wz) with T their product), v
    the ``index_window`` (w where None), tokens in (h, w, f) order of a v^3
    layout: sum over axes of (p_i - p_j + v - 1) * stride, computed as the
    kernel does, a row term of p_i plus a column term of p_j. Where T < v^3
    this is the v^3 index's first T rows and columns, so token t sits at
    (t // v^2, t // v % v, t % v) whatever the window's edges (Swin-UNETR's
    clamped windows: its index is built for the configured window and
    sliced to the tokens). Cached per device (made outside inference mode,
    so autograd may save it)."""
    edges = _edges(window)
    v = edges[0] if index_window is None else index_window
    s, t = 2 * v - 1, edges[0] * edges[1] * edges[2]
    with torch.inference_mode(False):
        pos = torch.arange(t, device=device)
        a, b, c = pos // (v * v), (pos // v) % v, pos % v
        row = ((a + v - 1) * s + b + v - 1) * s + c + v - 1
        col = (a * s + b) * s + c
        return row[:, None] - col[None, :]


def gather_bias(table: torch.Tensor, window: int, index_window=None) -> torch.Tensor:
    """The (heads, T, T) fp32 bias of a ((2v-1)^3, heads) table."""
    return table.float()[rel_pos_index(window, table.device, index_window)].permute(2, 0, 1)


def _edges(window) -> Tuple[int, int, int]:
    return (window,) * 3 if isinstance(window, int) else tuple(int(w) for w in window)


def _regions(padded: int, window: int, shift: int) -> torch.Tensor:
    """Each position's region along one padded axis: [0, P - w), [P - w,
    P - s), [P - s, P); one region where the axis is not shifted."""
    pos = torch.arange(padded)
    if shift == 0:
        return torch.zeros_like(pos)
    return (pos >= padded - window).long() + (pos >= padded - shift).long()


@functools.lru_cache(maxsize=None)
def shift_mask(grid, window, shift, device=None) -> torch.Tensor:
    """(windows, T, T) fp32 mask of a shifted block over the padded grid
    ``grid`` (Px, Py, Pz): ``MASK_VALUE`` between two tokens whose region
    triples differ, 0 elsewhere; windows in (x, y, z) order, tokens
    row-major inside (Swin-UNETR's ``compute_mask``). ``window`` and
    ``shift``: one edge and shift for every axis, or one each. Cached per
    device."""
    (wx, wy, wz), shifts = _edges(window), _edges(shift)
    rx, ry, rz = (_regions(p, w, sh) for p, w, sh in zip(grid, (wx, wy, wz), shifts))
    code = (rx[:, None, None] * 9 + ry[None, :, None] * 3 + rz[None, None, :])
    nx, ny, nz = grid[0] // wx, grid[1] // wy, grid[2] // wz
    code = code.reshape(nx, wx, ny, wy, nz, wz).permute(0, 2, 4, 1, 3, 5).reshape(
        -1, wx * wy * wz)
    with torch.inference_mode(False):
        diff = (code[:, :, None] != code[:, None, :]).float() * MASK_VALUE
        return diff.to(device)


def reference_window_attention(q, k, v, bias, dtype, attn_dropout=None, mask=None):
    """Plain core. q (pre-scaled), k, v: (n, T, heads*dh); bias
    (heads, T, T) fp32; ``mask``: None or a (windows, T, T) fp32 mask added
    after the bias, the n windows being batches of those windows in turn.
    Products of the compute-dtype inputs are summed in fp32 (the inputs are
    upcast, which is exact), as the JAX oracle's
    ``preferred_element_type=float32``. ``attn_dropout``: a callable
    applied to the softmaxed scores in the compute dtype (training only)."""
    n, t, c = q.shape
    heads = bias.shape[0]
    dh = c // heads

    def split(x):
        return x.reshape(n, t, heads, dh).transpose(1, 2).float()

    qh, kh, vh = split(q), split(k), split(v)
    sim = torch.matmul(qh, kh.transpose(-1, -2)) + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        sim = (sim.view(n // nw, nw, heads, t, t) + mask[None, :, None]).view(n, heads, t, t)
    attn = torch.softmax(sim, dim=-1).to(dtype)
    if attn_dropout is not None:
        attn = attn_dropout(attn)
    out = torch.matmul(attn.float(), vh).to(dtype)
    return out.transpose(1, 2).reshape(n, t, c)


def reference_window_attention_table(q, k, v, table, window: int, dtype, attn_dropout=None,
                                     index_window=None, shift=None):
    """Plain version of K2: the table gathered to (heads, T, T) (over the
    ``index_window`` layout), the ``shift`` mask materialized where given
    (``(grid, s)``: the padded grid and the cyclic shift), then the plain
    core."""
    mask = None if shift is None else shift_mask(tuple(shift[0]), window, shift[1], q.device)
    return reference_window_attention(q, k, v, gather_bias(table, window, index_window), dtype,
                                      attn_dropout, mask)


def supports(t: int, c: int, heads: int, dtype, index_window=None) -> bool:
    """Shapes the kernel takes: bf16; head width 32 over windows of w^3
    tokens with w <= 6 indexed as themselves; head width 16 over 7^3
    windows and 6^3 windows, both indexed over a 7^3 layout."""
    if dtype != torch.bfloat16 or heads < 1 or c != heads * (c // heads):
        return False
    inst = _INSTANCES.get(c // heads)
    w = round(t ** (1.0 / 3.0))
    if inst is None or w ** 3 != t:
        return False
    wmax, fixed = inst
    v = w if index_window is None else index_window
    if fixed is None:
        return w <= wmax and v == w
    return w in (wmax - 1, wmax) and v == fixed


def _ld(x: torch.Tensor) -> int:
    """Row stride of an (n, T, C) view whose rows may be strided."""
    n, t, c = x.shape
    if x.stride(2) != 1 or x.stride(0) != t * x.stride(1) or x.stride(1) % 8:
        raise ValueError(f"unsupported layout: shape {tuple(x.shape)} strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("window_attention needs 16-byte aligned rows")
    return x.stride(1)


def _masked_windows(grid, window: int) -> int:
    """Windows of a shifted block that hold more than one region: those
    on the last window of some axis."""
    nx, ny, nz = (p // window for p in grid)
    return nx * ny * nz - (nx - 1) * (ny - 1) * (nz - 1)


def window_attention(q, k, v, table, window: int, dtype, index_window=None, shift=None):
    """q (pre-scaled), k, v: (n_windows, w^3, heads*dh) in ``dtype``, rows
    may be strided views of one qkv tensor; table: ((2v-1)^3, heads) fp32,
    the layer's bias table, v the ``index_window`` (``window`` where None);
    ``shift``: None, or ``(grid, s)`` for a shifted block: the padded grid
    (Px, Py, Pz) the windows tile, batch by batch, and the cyclic shift s,
    whose region mask the kernel adds. Returns (n_windows, w^3, heads*dh)
    in ``dtype``. CPU tensors take the plain version; CUDA tensors launch
    ``csrc/window_attention.cu``, differentiable through the plain version.
    Counted on ``launches``, ``windows`` (windows run) and
    ``masked_windows`` (those of them that took the mask)."""
    def plain(q, k, v, table):
        return reference_window_attention_table(q, k, v, table, window, dtype,
                                                index_window=index_window, shift=shift)

    if not q.is_cuda:
        return plain(q, k, v, table)
    n, t, c = q.shape
    heads = table.shape[-1]
    iw = window if index_window is None else index_window
    if t != window ** 3 or not supports(t, c, heads, dtype, index_window):
        raise ValueError(f"window_attention kernel: unsupported T={t} window={window} "
                         f"index window={iw} C={c} heads={heads} {dtype}")
    if any(x.dtype != dtype or x.shape != q.shape or not x.is_cuda for x in (q, k, v)):
        raise ValueError("q, k, v must share shape, dtype and a CUDA device")
    if table.dtype != torch.float32 or tuple(table.shape) != ((2 * iw - 1) ** 3, heads) \
            or table.device != q.device:
        raise ValueError(f"table must be float32 ({(2 * iw - 1) ** 3}, {heads}) on q's device")
    grid, s = (0, 0, 0), 0
    if shift is not None:
        grid, s = tuple(int(p) for p in shift[0]), int(shift[1])
        nwin = (grid[0] // window) * (grid[1] // window) * (grid[2] // window)
        if any(p % window for p in grid) or not 0 < s < window or n % nwin:
            raise ValueError(f"window_attention kernel: shift {s} over grid {grid} does not "
                             f"tile {n} windows of {window}^3")
    return recompute(lambda q, k, v, table: _launch(q, k, v, table, window, iw, grid, s, dtype),
                     plain, q, k, v, table)


def _launch(q, k, v, table, window, index_window, grid, shift, dtype):
    n, t, c = q.shape
    table = table.contiguous()
    out = torch.empty((n, t, c), dtype=dtype, device=q.device)
    fn = kernels.bind(
        "window_attention", "window_attention",
        *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 13, ctypes.c_void_p,
    )
    heads = table.shape[1]
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), table.data_ptr(), out.data_ptr(),
        n, window, heads, _ld(q), _ld(k), _ld(v), c, c // heads, index_window, *grid, shift,
        kernels.stream_ptr(q.device),
    )
    kernels.check(err, "window_attention")
    window_attention.launches += 1
    window_attention.windows += n
    if shift:
        nwin = (grid[0] // window) * (grid[1] // window) * (grid[2] // window)
        window_attention.masked_windows += n // nwin * _masked_windows(grid, window)
    return out


window_attention.launches = 0
window_attention.windows = 0  # windows run (each of ``heads`` heads)
window_attention.masked_windows = 0  # of them, windows that took the shift mask
