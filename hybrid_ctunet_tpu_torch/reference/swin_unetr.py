"""Plain float32 reference of Swin-UNETR (MONAI's
``monai/networks/nets/swin_unetr.py``, v1, ``downsample="merging"``; the
BTCV model of arXiv:2111.14791), channels-last (B, X, Y, Z, C). Every
product is a plain float32 ``torch`` op (TF32 off), the bias table is
gathered to (heads, T, T) and the shift mask materialized as MONAI does; it
imports no kernel and no op of the port. Parameter names are MONAI's
state-dict keys, so one state dict loads into this model, the port's
``models.SwinUNETR`` and MONAI's.

Departures from the paper, both MONAI's and kept for its checkpoints:

- the relative-position index is built for the configured 7^3 window and
  sliced ``[:n, :n]`` to a window's n tokens, so a 6^3 window (stage 4 of
  a 96^3 ROI, where the map clamps the window) reads the table as if its
  tokens sat in a 7^3 layout;
- patch merging concatenates the strided sub-volumes in MONAI's v0.9.0
  order (0,0,0), (1,0,0), (0,1,0), (0,0,1), (1,0,1), (0,1,0), (0,0,1),
  (1,1,1), two of them twice.

The benchmark keeps a frozen copy of these equations of its own
(``benchmark/reference/swin_unetr.py``); a test holds the two equal.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

MERGE_ORDER = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0), (0, 0, 1),
               (1, 1, 1))


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


def relative_position_index(window: int) -> torch.Tensor:
    """MONAI's ``relative_position_index`` of a window^3 layout: (w^3, w^3)."""
    w = window
    coords = torch.stack(torch.meshgrid(torch.arange(w), torch.arange(w), torch.arange(w),
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 2] += w - 1
    rel[:, :, 0] *= (2 * w - 1) * (2 * w - 1)
    rel[:, :, 1] *= 2 * w - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, ws: Sequence[int]) -> torch.Tensor:
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows: torch.Tensor, ws: Sequence[int], dims: Sequence[int]) -> torch.Tensor:
    b, d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def compute_mask(dims: Sequence[int], ws: Sequence[int], shift: Sequence[int]) -> torch.Tensor:
    """MONAI's ``compute_mask``: (windows, n, n), -100 between tokens of
    different regions of the padded grid ``dims``, 0 elsewhere."""
    d, h, w = dims
    img_mask = torch.zeros((1, d, h, w, 1))
    cnt = 0
    for ds in slice(-ws[0]), slice(-ws[0], -shift[0]), slice(-shift[0], None):
        for hs in slice(-ws[1]), slice(-ws[1], -shift[1]), slice(-shift[1], None):
            for wsl in slice(-ws[2]), slice(-ws[2], -shift[2]), slice(-shift[2], None):
                img_mask[:, ds, hs, wsl, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, ws).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(attn_mask == 0, 0.0)


def get_window_size(size, window, shift):
    ws, sh = list(window), list(shift)
    for i in range(len(size)):
        if size[i] <= window[i]:
            ws[i], sh[i] = size[i], 0
    return tuple(ws), tuple(sh)


class Linear(nn.Module):
    def __init__(self, cin, cout, bias=True):
        super().__init__()
        self.weight = _param(cout, cin)
        self.bias = _param(cout) if bias else None

    def forward(self, x):
        y = torch.matmul(x, self.weight.t())
        return y + self.bias if self.bias is not None else y


class LayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight, self.bias = _param(dim), _param(dim)

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, 1e-5)


def conv(x, w, stride):
    """SAME-padded conv of a channels-last x (MONAI's padding)."""
    pad = tuple((k - s + 1) // 2 for k, s in zip(w.shape[2:], stride))
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 4, 1)


def instance_norm(x, act: bool):
    y = F.instance_norm(x.permute(0, 4, 1, 2, 3), eps=1e-5).permute(0, 2, 3, 4, 1)
    return F.leaky_relu(y, 0.01) if act else y


class _ConvW(nn.Module):
    def __init__(self, cin, cout, k, bias=False):
        super().__init__()
        self.weight = _param(cout, cin, k, k, k)
        self.bias = _param(cout) if bias else None


class Conv(nn.Module):
    """MONAI's ``Convolution`` (key ``conv``)."""

    def __init__(self, cin, cout, k, stride=1, bias=False):
        super().__init__()
        self.stride = (stride,) * 3
        self.conv = _ConvW(cin, cout, k, bias)

    def forward(self, x):
        y = conv(x, self.conv.weight, self.stride)
        return y + self.conv.bias if self.conv.bias is not None else y


class UnetResBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.proj = cin != cout
        self.conv1 = Conv(cin, cout, 3)
        self.conv2 = Conv(cout, cout, 3)
        if self.proj:
            self.conv3 = Conv(cin, cout, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        out = instance_norm(self.conv1(x), True)
        out = instance_norm(self.conv2(out), False)
        res = instance_norm(self.conv3(x), False) if self.proj else x
        return F.leaky_relu(out + res, 0.01)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.layer = UnetResBlock(cin, cout)


class _TW(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = _param(cin, cout, 2, 2, 2)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.transp_conv = nn.Module()
        self.transp_conv.conv = _TW(cin, cout)
        self.conv_block = UnetResBlock(2 * cout, cout)

    def forward(self, x, skip):
        up = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), self.transp_conv.conv.weight,
                                stride=2).permute(0, 2, 3, 4, 1)
        return self.conv_block(up, skip)


class UnetOutBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = Conv(cin, cout, 1, bias=True)

    def forward(self, x):
        return self.conv(x)


class WindowAttention(nn.Module):
    def __init__(self, dim, heads, window):
        super().__init__()
        self.heads, self.window = heads, window
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = _param((2 * window - 1) ** 3, heads)
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "relative_position_index", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x, mask):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * self.scale
        attn = torch.matmul(q, k.transpose(-2, -1))
        index = relative_position_index(self.window)[:n, :n].reshape(-1).to(x.device)
        bias = self.relative_position_bias_table[index].reshape(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, self.heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class MLPBlock(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.linear1 = Linear(dim, hidden)
        self.linear2 = Linear(hidden, dim)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, heads, window, shift, mlp_ratio):
        super().__init__()
        self.window, self.shift = (window,) * 3, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x, mask):
        shortcut = x
        b, d, h, w, c = x.shape
        ws, sh = get_window_size((d, h, w), self.window, self.shift)
        x = self.norm1(x)
        pd, pb, pr = ((ws[i] - s % ws[i]) % ws[i] for i, s in enumerate((d, h, w)))
        x = F.pad(x, (0, 0, 0, pr, 0, pb, 0, pd))
        _, dp, hp, wp, _ = x.shape
        if any(i > 0 for i in sh):
            x = torch.roll(x, shifts=(-sh[0], -sh[1], -sh[2]), dims=(1, 2, 3))
            attn_mask = mask
        else:
            attn_mask = None
        windows = self.attn(window_partition(x, ws), attn_mask)
        x = window_reverse(windows.view(-1, *ws, c), ws, (b, dp, hp, wp))
        if any(i > 0 for i in sh):
            x = torch.roll(x, shifts=sh, dims=(1, 2, 3))
        x = x[:, :d, :h, :w, :].contiguous()
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(8 * dim)
        self.reduction = Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, d, h, w, c = x.shape
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in MERGE_ORDER], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, heads, window, mlp_ratio):
        super().__init__()
        self.window, self.shift = (window,) * 3, (window // 2,) * 3
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, heads, window, (0, 0, 0) if i % 2 == 0 else self.shift,
                                 mlp_ratio) for i in range(depth))
        self.downsample = PatchMerging(dim)

    def forward(self, x):
        b, d, h, w, c = x.shape
        ws, sh = get_window_size((d, h, w), self.window, self.shift)
        dims = [-(-s // ws[i]) * ws[i] for i, s in enumerate((d, h, w))]
        mask = compute_mask(dims, ws, sh).to(x.device)
        for blk in self.blocks:
            x = blk(x, mask)
        return self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.proj = _ConvW(cin, dim, 2, bias=True)

    def forward(self, x):
        return conv(x, self.proj.weight, (2, 2, 2)) + self.proj.bias


class SwinTransformer(nn.Module):
    def __init__(self, cin, dim, depths, heads, window, mlp_ratio):
        super().__init__()
        self.patch_embed = PatchEmbed(cin, dim)
        for i in range(4):
            self.add_module(f"layers{i + 1}", nn.ModuleList(
                [BasicLayer(dim * 2 ** i, depths[i], heads[i], window, mlp_ratio)]))

    def forward(self, x) -> List[torch.Tensor]:
        def out(t):
            return F.layer_norm(t, (t.shape[-1],))

        h = self.patch_embed(x)
        outs = [out(h)]
        for i in range(4):
            h = getattr(self, f"layers{i + 1}")[0](h)
            outs.append(out(h))
        return outs


class SwinUNETR(nn.Module):
    """``forward(x)`` on (B, X, Y, Z, in_channels) float32 returns
    ``(logits,)``."""

    def __init__(self, in_channels: int = 1, out_channels: int = 14, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0):
        super().__init__()
        fs = feature_size
        self.swinViT = SwinTransformer(in_channels, fs, depths, num_heads, window_size, mlp_ratio)
        self.encoder1 = UnetrBasicBlock(in_channels, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = UnetOutBlock(fs, out_channels)

    def forward(self, x) -> Tuple[torch.Tensor]:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        h0, h1, h2, h3, h4 = self.swinViT(x)
        enc0 = self.encoder1.layer(x)
        enc1 = self.encoder2.layer(h0)
        enc2 = self.encoder3.layer(h1)
        enc3 = self.encoder4.layer(h2)
        dec4 = self.encoder10.layer(h4)
        dec3 = self.decoder5(dec4, h3)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        return (self.out(self.decoder1(dec0, enc0)),)
