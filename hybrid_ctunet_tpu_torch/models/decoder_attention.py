"""TUNet's conv-free attention decoder (reference UpAttentionBlock,
hybrid_CTUNet.py:528-591). Port of
``hybrid_ctunet_tpu/models/decoder_attention.py``.

Stages 0-2: residual block-window attention + FFN, residual grid-window
attention + FFN, pixel shuffle. Stage 3 (full resolution): two residual
FFNs — the fused pair kernel on CUDA in bf16 — and a pixel shuffle. Returns
the 5-level pyramid [hidden, 512, 256, 128, 64].

Keys follow the reference's Sequentials: ``layers.{ind}.0.{1,2,5,6}.fn``
and ``.8`` for stages 0-2, ``layers.3.0.{1,2}.fn`` and ``.4`` for stage 3;
the other indices are the reference's Rearranges (``nn.Identity`` here).
``dropout`` reaches every attention and FFN; with it active (train mode)
stage 3 runs its two FFNs unfused, as the JAX package's pair is fused only
when ``dr == 0 or deterministic`` (``decoder_attention.py:71-76``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops import ffn as ffn_ops
from .layers import FeedForward, MultiAxisWindowAttention, PixelShuffleLinear, Residual


class UpAttentionBlock(nn.Module):
    def __init__(self, in_channels: int = 768, dims: Sequence[int] = (128, 256, 512, 1024),
                 ds_stride: Sequence[Tuple[int, int, int]] = ((2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2)),
                 window: int = 6, dropout: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        # (in_channels, *dims[::-1][1:], 64): (768, 512, 256, 128, 64)
        chain = (in_channels, *list(dims)[::-1][1:], 64)
        factors = list(ds_stride)[::-1]
        kw = dict(dtype=dtype, device=device)
        stages = []
        for ind, (dim_in, dim_out) in enumerate(zip(chain[:-1], chain[1:])):
            shuffle = PixelShuffleLinear(dim_in, factors[ind], dim_out, **kw)
            ff = lambda: Residual(FeedForward(dim_in, 4 * dim_in, residual=True, dropout=dropout,
                                              **kw))
            if ind <= 2:
                attn = lambda grid: Residual(
                    MultiAxisWindowAttention(dim_in, window, grid=grid, dropout=dropout, **kw))
                seq = nn.Sequential(
                    nn.Identity(), attn(False), ff(), nn.Identity(),
                    nn.Identity(), attn(True), ff(), nn.Identity(), shuffle,
                )
            else:
                seq = nn.Sequential(nn.Identity(), ff(), ff(), nn.Identity(), shuffle)
            stages.append(nn.ModuleList([seq]))
        self.layers = nn.ModuleList(stages)

    def forward(self, x, stages: int = 4):
        """The pyramid [x, stage 0 out, ..., stage ``stages``-1 out]."""
        features = [x]
        for ind, stage in enumerate(self.layers[:stages]):
            seq = stage[0]
            if ind <= 2:
                x = x + seq[1].fn(x)
                x = seq[2].fn(x)
                x = x + seq[5].fn(x)
                x = seq[6].fn(x)
                shuffle = seq[8]
            else:
                ff1, ff2 = seq[1].fn, seq[2].fn
                p1, p2 = ff1.params(), ff2.params()
                if not ff1.dropping() and ffn_ops.pair_supports(x.shape[-1], p1[2].shape[0],
                                                                self.dtype):
                    x = ffn_ops.ffn_pair(x, p1, p2, self.dtype)
                else:
                    x = ff2(ff1(x))
                shuffle = seq[4]
            x = shuffle(x)
            features.append(x)
        return features
