"""TUNet — transformer U-Net: 3D ViT encoder + attention/pixel-shuffle
decoder + full-resolution conv stem. Port of
``hybrid_ctunet_tpu/models/tunet.py`` (reference TUNet,
hybrid_CTUNet.py:939-1036), in the standard layout (the JAX package's FOLD96
z-fold is the same math).

109,904,124 params at pf 8 (ViT 86.94 M + decoder 22.51 M). Attribute names
are the reference's state-dict prefixes: ``vit``, ``vit_encoder``,
``vit_encoder0.layer``, ``vit_decoder0``, ``decoder_linear_96x96.head``,
``vit_out``.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .decoder_attention import UpAttentionBlock
from .layers import CatConvBlock, Dense, ResBlock, UnetOutHead, maybe_remat
from .vit3d import ViT3D

DIMS = (128, 256, 512, 1024)
DS_STRIDE = ((2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2))


class _Holder(nn.Module):
    """Gives a child the reference's extra key level (``.layer``, ``.head``)."""

    def __init__(self, **children):
        super().__init__()
        for name, mod in children.items():
            self.add_module(name, mod)


class TUNetCore(nn.Module):
    """ViT -> token grid -> UpAttentionBlock pyramid; conv stem; fused
    full-res output head + per-voxel linear head. ``forward`` returns
    (vit_logits, vit_96, pyramid), channels-last."""

    def __init__(self, out_channels: int = 14, in_channels: int = 1, dim_conv_stem: int = 64,
                 img_size: Tuple[int, int] = (96, 96), frames: int = 96, patch_frame: int = 8,
                 hidden_size: int = 768, num_depths: int = 12, mlp_dim: int = 3072,
                 num_heads: int = 12, window: int = 6, dropout_rate: float = 0.0,
                 norm_name: str = "instance", dtype=torch.float32, device=None):
        super().__init__()
        gh, gw, gf = img_size[0] // 16, img_size[1] // 16, frames // patch_frame
        up_xy = 2 * 2 * 2 * 2
        up_z = 1
        for s in DS_STRIDE:
            up_z *= s[2]
        if (gh * up_xy, gw * up_xy, gf * up_z) != (img_size[0], img_size[1], frames):
            raise ValueError(
                f"patch_frame={patch_frame} at {(*img_size, frames)}: the decoder pyramid "
                f"ends at {(gh * up_xy, gw * up_xy, gf * up_z)}, not the input size "
                f"(it upsamples z by {up_z}, so patch_frame must be {up_z})"
            )
        if gh % window or gw % window or gf % window:
            raise ValueError(f"token grid {(gh, gw, gf)} not divisible by window {window}")
        self.grid = (gh, gw, gf)
        self.hidden_size = hidden_size
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.vit = ViT3D(img_size, frames, 16, patch_frame, in_channels, hidden_size,
                         num_depths, num_heads, 64, mlp_dim, dropout_rate, **kw)
        self.vit_encoder = UpAttentionBlock(hidden_size, DIMS, DS_STRIDE, window, dropout_rate,
                                            **kw)
        self.vit_encoder0 = _Holder(layer=ResBlock(in_channels, dim_conv_stem, 3, 1,
                                                   norm_name=norm_name, **kw))
        self.vit_decoder0 = CatConvBlock(64 + dim_conv_stem, dim_conv_stem, 3,
                                         norm_name=norm_name, **kw)
        self.vit_out = UnetOutHead(dim_conv_stem, out_channels, **kw)
        self.decoder_linear_96x96 = _Holder(head=Dense(64, out_channels, **kw))

    def pyramid(self, x, stages: int = 4):
        """ViT tokens -> grid -> the decoder pyramid through ``stages``."""
        tokens = self.vit(x)
        grid = tokens.reshape(x.shape[0], *self.grid, self.hidden_size)  # tokens (h w f) -> grid
        return self.vit_encoder(grid, stages)

    def heads(self, x, pyramid):
        """Conv stem, full-resolution decoder, and the two output heads."""
        stem = maybe_remat(self.vit_encoder0.layer, x)
        fused = self.vit_decoder0(pyramid[-1], stem)
        return self.vit_out(fused), self.decoder_linear_96x96.head(pyramid[-1])

    def forward(self, x):
        pyramid = self.pyramid(x)
        vit_logits, vit_96 = self.heads(x, pyramid)
        return vit_logits, vit_96, pyramid


class TUNet(TUNetCore):
    """Returns (vit_logits, vit_96), channels-last (B, X, Y, Z, out)."""

    def forward(self, x):
        vit_logits, vit_96, _ = super().forward(x)
        return vit_logits, vit_96
