"""Swin-UNETR (Hatamizadeh et al., arXiv:2201.01266), the BTCV model of Tang
et al. (arXiv:2111.14791): a 3D shifted-window transformer encoder and the
UNETR conv decoder. The equations and state-dict keys are MONAI's
``monai/networks/nets/swin_unetr.py`` (v1, ``downsample="merging"``), so a
MONAI checkpoint loads with ``load_state_dict``; the buffer
``relative_position_index`` such a checkpoint holds is accepted and
dropped (the index is computed, ``ops.attention.rel_pos_index``).

Channels-last (B, X, Y, Z, C), so Swin's (d, h, w) are (x, y, z). Params
fp32, compute in ``dtype``. At the BTCV widths (feature size 48, depths
(2, 2, 2, 2), heads (3, 6, 12, 24), window 7, ROI 96^3, 1 input channel, 14
classes) 62,187,296 parameters.

Two of MONAI's quirks are kept for its checkpoints:

- the relative-position index is built for the configured 7^3 window and
  sliced to a window's tokens, so at a map of 6^3 (stage 4 of a 96^3 ROI),
  whose window clamps to 6^3, token t reads the table at the 7^3 layout's
  position (t // 49, t // 7 % 7, t % 7);
- patch merging concatenates the strided sub-volumes in MONAI's v0.9.0
  order, (0,0,0), (1,0,0), (0,1,0), (0,0,1), (1,0,1), (0,1,0), (0,0,1),
  (1,1,1): two repeat and two never appear.

The attention core is K2 (``ops.attention.window_attention``, its head
width 16 instance with the shift mask) where its gate takes the shape;
InstanceNorms and residual tails are K8 through the port's ``ResBlock``.
Under a profiler a forward is the spans ``swin.encoder`` (patch embed to the
last stage's output) and ``swin.decoder`` (the conv encoders, decoders and
head).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import attention as attention_ops
from ..ops import ffn as ffn_ops
from ..ops.conv import conv3d_same
from ..utils import profiling
from .layers import (Conv3dWeights, Dense, LayerNorm, ResBlock, UnetOutHead, UpCatConvBlock,
                     _empty, maybe_remat)
from .tunet import _Holder

# MONAI's PatchMerging (v0.9.0): the strided sub-volumes, as its list has them
MERGE_ORDER = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0), (0, 0, 1),
               (1, 1, 1))
STAGES = 4


def window_and_shift(size: Sequence[int], window: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """MONAI's ``get_window_size``: per axis the window, clamped to the map
    where the map is no larger, and the shift window // 2, 0 there."""
    ws = tuple(s if s <= window else window for s in size)
    return ws, tuple(0 if s <= window else window // 2 for s in size)


class PatchEmbed(nn.Module):
    """Conv k = s = 2 with bias (MONAI's ``PatchEmbed`` without a norm);
    key ``proj.weight``, ``proj.bias``."""

    def __init__(self, cin: int, dim: int, patch: int = 2, dtype=torch.float32, device=None):
        super().__init__()
        self.patch, self.dtype = patch, dtype
        self.proj = Conv3dWeights(cin, dim, patch, True, device=device)

    def forward(self, x):
        y = conv3d_same(x.to(self.dtype), self.proj.weight.to(self.dtype), self.patch)
        return y + self.proj.bias.to(self.dtype)


class WindowAttention(nn.Module):
    """W-MSA / SW-MSA core of a block: ``qkv`` (bias) over the windows, q
    scaled by head width^-1/2, scores + the relative-position bias (+ the
    shift mask), softmax, PV, ``proj`` (bias). The ((2v-1)^3, heads) table
    is ``relative_position_bias_table``, v the configured window."""

    def __init__(self, dim: int, heads: int, window: int, dtype=torch.float32, device=None):
        super().__init__()
        self.heads, self.window, self.dtype = heads, window, dtype
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = _empty((2 * window - 1) ** 3, heads, device=device)
        self.qkv = Dense(dim, 3 * dim, bias=True, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, bias=True, dtype=dtype, device=device)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "relative_position_index", None)  # computed, not stored
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, h, ws, shift, grid):
        """h: (windows, T, C); ``ws`` the window's edges, ``shift`` the
        block's shifts (all 0: not shifted) and ``grid`` the padded map."""
        n, t, c = h.shape
        q, k, v = self.qkv(h).split(c, dim=-1)
        q = q * self.scale
        table = self.relative_position_bias_table
        cubic = ws[0] == ws[1] == ws[2] and shift[0] == shift[1] == shift[2]
        if cubic and attention_ops.supports(t, c, self.heads, self.dtype, self.window):
            out = attention_ops.window_attention(
                q, k, v, table, ws[0], self.dtype, index_window=self.window,
                shift=(grid, shift[0]) if shift[0] else None)
        else:
            out = attention_ops.reference_window_attention_table(
                q, k, v, table, ws, self.dtype, index_window=self.window,
                shift=(grid, shift) if any(shift) else None)
        return self.proj(out)


class Mlp(nn.Module):
    """Linear(C, 4C) -> erf GELU -> Linear(4C, C), biases (MONAI's
    ``MLPBlock``: keys ``linear1``, ``linear2``)."""

    def __init__(self, dim: int, hidden: int, dtype=torch.float32, device=None):
        super().__init__()
        self.linear1 = Dense(dim, hidden, dtype=dtype, device=device)
        self.linear2 = Dense(hidden, dim, dtype=dtype, device=device)


class SwinBlock(nn.Module):
    """x + Attn(LN1(x)), then x + MLP(LN2(x)). The attention zero-pads
    LN1(x) at each axis's end to whole windows, rolls a shifted block by
    -shift, partitions into windows in (x, y, z) order (tokens row-major),
    and undoes the three after."""

    def __init__(self, dim: int, heads: int, window: int, mlp_ratio: float = 4.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = WindowAttention(dim, heads, window, dtype=dtype, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype=dtype, device=device)

    def forward(self, x, ws, shift):
        B, X, Y, Z, C = x.shape
        h = self.norm1(x)
        pads = [(-s) % w for s, w in zip((X, Y, Z), ws)]
        if any(pads):
            h = F.pad(h, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        grid = (X + pads[0], Y + pads[1], Z + pads[2])
        if any(shift):
            h = torch.roll(h, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
        (wx, wy, wz), (nx, ny, nz) = ws, (g // w for g, w in zip(grid, ws))
        h = h.reshape(B, nx, wx, ny, wy, nz, wz, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
        out = self.attn(h.reshape(-1, wx * wy * wz, C), ws, shift, grid)
        out = out.reshape(B, nx, ny, nz, wx, wy, wz, C).permute(0, 1, 4, 2, 5, 3, 6, 7)
        out = out.reshape(B, *grid, C)
        if any(shift):
            out = torch.roll(out, shifts=tuple(shift), dims=(1, 2, 3))
        if any(pads):
            out = out[:, :X, :Y, :Z]
        x = x + out
        p = (self.norm2.weight, self.norm2.bias, self.mlp.linear1.weight, self.mlp.linear1.bias,
             self.mlp.linear2.weight, self.mlp.linear2.bias)
        if ffn_ops.supports(C, p[2].shape[0], self.dtype):
            return ffn_ops.ffn(x, *p, self.dtype, residual=True)
        return x + ffn_ops.reference_ffn(x, *p, self.dtype)


class PatchMerging(nn.Module):
    """The eight strided sub-volumes in ``MERGE_ORDER`` concatenated on
    channels (odd extents zero-padded first), LayerNorm(8C),
    Linear(8C -> 2C) without bias."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.norm = LayerNorm(8 * dim, device=device)
        self.reduction = Dense(8 * dim, 2 * dim, bias=False, dtype=dtype, device=device)

    def forward(self, x):
        X, Y, Z = x.shape[1:4]
        if X % 2 or Y % 2 or Z % 2:
            x = F.pad(x, (0, 0, 0, Z % 2, 0, Y % 2, 0, X % 2))
        x = torch.cat([x[:, i::2, j::2, k::2] for i, j, k in MERGE_ORDER], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """A stage: blocks alternating unshifted and shifted, then merging."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList(SwinBlock(dim, heads, window, mlp_ratio, dtype, device)
                                    for _ in range(depth))
        self.downsample = PatchMerging(dim, dtype, device)

    def forward(self, x):
        ws, shift = window_and_shift(x.shape[1:4], self.window)
        for i, blk in enumerate(self.blocks):
            x = maybe_remat(blk, x, ws, shift if i % 2 else (0, 0, 0))
        return self.downsample(x)


class SwinTransformer(nn.Module):
    """Patch embed and four stages; returns the five maps, each
    LayerNorm'ed over channels without an affine (MONAI's ``proj_out``)."""

    def __init__(self, cin: int, dim: int, depths: Sequence[int], heads: Sequence[int],
                 window: int, mlp_ratio: float, dtype=torch.float32, device=None):
        super().__init__()
        self.patch_embed = PatchEmbed(cin, dim, dtype=dtype, device=device)
        for i in range(STAGES):
            self.add_module(f"layers{i + 1}", nn.ModuleList([BasicLayer(
                dim * 2 ** i, depths[i], heads[i], window, mlp_ratio, dtype, device)]))

    @staticmethod
    def _out(x):
        return F.layer_norm(x.float(), (x.shape[-1],), eps=1e-5).to(x.dtype)

    def forward(self, x):
        h = self.patch_embed(x)
        outs = [self._out(h)]
        for i in range(STAGES):
            h = getattr(self, f"layers{i + 1}")[0](h)
            outs.append(self._out(h))
        return outs


class SwinUNETR(nn.Module):
    """Swin-UNETR; ``forward(x)`` on (B, X, Y, Z, in_channels), each spatial
    extent a multiple of 32, returns ``(logits,)``, (B, X, Y, Z,
    out_channels) in ``dtype``."""

    def __init__(self, img_size: Sequence[int] = (96, 96, 96), in_channels: int = 1,
                 out_channels: int = 14, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0, norm_name: str = "instance",
                 dtype=torch.float32, device=None):
        super().__init__()
        if feature_size % 12:
            raise ValueError(f"feature_size {feature_size} must be divisible by 12")
        if any(s % 32 for s in img_size):
            raise ValueError(f"img_size {tuple(img_size)}: each extent must be a multiple of 32")
        self.img_size, self.dtype = tuple(img_size), dtype
        fs = feature_size
        kw = dict(dtype=dtype, device=device)
        self.swinViT = SwinTransformer(in_channels, fs, depths, num_heads, window_size,
                                       mlp_ratio, **kw)

        def enc(cin, cout):
            return _Holder(layer=ResBlock(cin, cout, 3, 1, norm_name=norm_name, **kw))

        self.encoder1 = enc(in_channels, fs)
        self.encoder2 = enc(fs, fs)
        self.encoder3 = enc(2 * fs, 2 * fs)
        self.encoder4 = enc(4 * fs, 4 * fs)
        self.encoder10 = enc(16 * fs, 16 * fs)
        for name, cin, cout in (("decoder5", 16, 8), ("decoder4", 8, 4), ("decoder3", 4, 2),
                                ("decoder2", 2, 1), ("decoder1", 1, 1)):
            self.add_module(name, UpCatConvBlock(cin * fs, cout * fs, 2, 3, norm_name, **kw))
        self.out = UnetOutHead(fs, out_channels, **kw)

    def forward(self, x):
        if any(s % 32 for s in x.shape[1:4]):
            raise ValueError(f"input {tuple(x.shape[1:4])}: each extent must be a multiple of 32")
        x = x.to(self.dtype)
        with profiling.span("swin.encoder"):
            h0, h1, h2, h3, h4 = self.swinViT(x)
        with profiling.span("swin.decoder"):
            enc0 = maybe_remat(self.encoder1.layer, x)
            enc1 = maybe_remat(self.encoder2.layer, h0)
            enc2 = maybe_remat(self.encoder3.layer, h1)
            enc3 = maybe_remat(self.encoder4.layer, h2)
            dec4 = maybe_remat(self.encoder10.layer, h4)
            dec3 = self.decoder5(dec4, h3)
            dec2 = self.decoder4(dec3, enc3)
            dec1 = self.decoder3(dec2, enc2)
            dec0 = self.decoder2(dec1, enc1)
            logits = self.out(self.decoder1(dec0, enc0))
        return (logits,)
