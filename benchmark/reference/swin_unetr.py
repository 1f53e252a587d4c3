"""Plain PyTorch reference of Swin-UNETR for the benchmark: a frozen copy of
its equations (MONAI's ``monai/networks/nets/swin_unetr.py``, v1,
``downsample="merging"``; the BTCV model of arXiv:2111.14791) written for
the benchmark alone, channels-last (B, X, Y, Z, C). It imports nothing of
the program. Parameter names are MONAI's state-dict keys, so one state dict
loads into this model and the program's.

Every conv and matrix product goes through a ``models.Arith`` (float32, or
float8 operands for the control); the conv blocks are ``models``' own
(``ResBlock``, ``ConvTranspose3d``, ``UnetOutHead``), whose InstanceNorms
``Arith.norm_sites`` records while ``Arith.recording`` is set. While it is
set, each window attention's (windows, heads, tokens, head width) goes to
the list ``Arith.attn_sites`` that :func:`build` gives the arithmetic (the
K2 bound counts them). The bias table is gathered and the shift mask materialized as
MONAI does. MONAI's two quirks are kept: the 7^3 relative-position index
sliced ``[:n, :n]`` to a clamped window's tokens, and the v0.9.0 patch
merging order, in which two sub-volumes repeat.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import models

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


class _Holder(nn.Module):
    def __init__(self, **children):
        super().__init__()
        for name, mod in children.items():
            self.add_module(name, mod)


class UnetrUpBlock(nn.Module):
    def __init__(self, ar, cin, cout):
        super().__init__()
        self.transp_conv = models.ConvTranspose3d(ar, cin, cout, 2)
        self.conv_block = models.ResBlock(ar, 2 * cout, cout)

    def forward(self, x, skip):
        return self.conv_block(self.transp_conv(x), skip)


class WindowAttention(nn.Module):
    def __init__(self, ar, dim, heads, window):
        super().__init__()
        self.ar, self.heads, self.window = ar, heads, window
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = _param((2 * window - 1) ** 3, heads)
        self.qkv = models.Dense(ar, dim, 3 * dim)
        self.proj = models.Dense(ar, dim, dim)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(prefix + "relative_position_index", None)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x, mask):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * self.scale
        if self.ar.recording:
            self.ar.attn_sites.append((b, self.heads, n, c // self.heads))
        attn = self.ar.matmul(q, k.transpose(-2, -1))
        index = relative_position_index(self.window)[:n, :n].reshape(-1).to(x.device)
        bias = self.relative_position_bias_table[index].reshape(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, self.heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = self.ar.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class MLPBlock(nn.Module):
    def __init__(self, ar, dim, hidden):
        super().__init__()
        self.linear1 = models.Dense(ar, dim, hidden)
        self.linear2 = models.Dense(ar, hidden, dim)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, ar, dim, heads, window, shift, mlp_ratio):
        super().__init__()
        self.window, self.shift = (window,) * 3, shift
        self.norm1 = models.LayerNorm(dim)
        self.attn = WindowAttention(ar, dim, heads, window)
        self.norm2 = models.LayerNorm(dim)
        self.mlp = MLPBlock(ar, dim, int(dim * mlp_ratio))

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
    def __init__(self, ar, dim):
        super().__init__()
        self.norm = models.LayerNorm(8 * dim)
        self.reduction = models.Dense(ar, 8 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, d, h, w, c = x.shape
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, i::2, j::2, k::2, :] for i, j, k in MERGE_ORDER], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, ar, dim, depth, heads, window, mlp_ratio):
        super().__init__()
        self.window, self.shift = (window,) * 3, (window // 2,) * 3
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(ar, dim, heads, window, (0, 0, 0) if i % 2 == 0 else self.shift,
                                 mlp_ratio) for i in range(depth))
        self.downsample = PatchMerging(ar, dim)

    def forward(self, x):
        b, d, h, w, c = x.shape
        ws, sh = get_window_size((d, h, w), self.window, self.shift)
        dims = [-(-s // ws[i]) * ws[i] for i, s in enumerate((d, h, w))]
        mask = compute_mask(dims, ws, sh).to(x.device)
        for blk in self.blocks:
            x = blk(x, mask)
        return self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, ar, cin, dim):
        super().__init__()
        self.ar = ar
        self.proj = models._ConvWeights(cin, dim, (2, 2, 2), True)

    def forward(self, x):
        return self.ar.conv(x, self.proj.weight, (2, 2, 2)) + self.proj.bias


class SwinTransformer(nn.Module):
    def __init__(self, ar, cin, dim, depths, heads, window, mlp_ratio):
        super().__init__()
        self.patch_embed = PatchEmbed(ar, cin, dim)
        for i in range(4):
            self.add_module(f"layers{i + 1}", nn.ModuleList(
                [BasicLayer(ar, dim * 2 ** i, depths[i], heads[i], window, mlp_ratio)]))

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
    """``forward(x)`` on (B, X, Y, Z, in_channels) returns the logits."""

    def __init__(self, ar, in_channels=1, out_channels=14, feature_size=48,
                 depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window_size=7, mlp_ratio=4.0):
        super().__init__()
        fs = feature_size
        self.swinViT = SwinTransformer(ar, in_channels, fs, depths, num_heads, window_size,
                                       mlp_ratio)

        def enc(cin, cout):
            return _Holder(layer=models.ResBlock(ar, cin, cout))

        self.encoder1 = enc(in_channels, fs)
        self.encoder2 = enc(fs, fs)
        self.encoder3 = enc(2 * fs, 2 * fs)
        self.encoder4 = enc(4 * fs, 4 * fs)
        self.encoder10 = enc(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(ar, 16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(ar, 8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(ar, 4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(ar, 2 * fs, fs)
        self.decoder1 = UnetrUpBlock(ar, fs, fs)
        self.out = models.UnetOutHead(ar, fs, out_channels)

    def forward(self, x):
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
        return self.out(self.decoder1(dec0, enc0))


def build(sizes: dict, ar: "models.Arith", device=None) -> SwinUNETR:
    """The reference at ``sizes`` (a configuration file's ``model`` group),
    parameters uninitialized on ``device``; ``ar`` gets its
    ``attn_sites`` list."""
    ar.attn_sites = []
    with torch.device(device or "cpu"):
        return SwinUNETR(ar, sizes["in_channels"], sizes["out_channels"], sizes["feature_size"],
                         tuple(sizes["depths"]), tuple(sizes["num_heads"]), sizes["window_size"],
                         sizes["mlp_ratio"])
