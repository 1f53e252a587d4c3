"""3D bottleneck ResNet encoder (channels-last, InstanceNorm or BatchNorm,
LeakyReLU 0.01).
Port of the plain-layout branch of ``hybrid_ctunet_tpu/models/resnet3d.py``
(reference networks/resnet.py:82-245); the JAX package's z-folded stages
are the same math and are not ported.

Layer counts 50 [3,4,6,3], 101 [8,9,13,3], 152 [8,9,30,3], 200 [8,25,30,3];
stage widths 32/64/128/256 x expansion 4; a 7x7x7 stem of 64 at stride
(2,2,1), no max-pool; stage strides 1, (2,2,2) x 3; 1x1x1 projection
shortcuts. At 96^3 the stages give 128@48x48x96, 256@24x24x48,
512@12x12x24, 1024@6x6x12. Keys: ``conv1.conv``,
``layer{s}.{b}.conv{1,2,3}.conv``, ``layer{s}.{b}.downsample.0.conv``;
under ``norm_name="batch"`` also ``norm1`` (the stem's),
``layer{s}.{b}.norm{1,2,3}`` and ``layer{s}.{b}.downsample.1``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.conv import _triple
from .layers import Conv3d, ConvNorm, maybe_remat

LAYER_COUNTS = {
    50: (3, 4, 6, 3),
    101: (8, 9, 13, 3),
    152: (8, 9, 30, 3),
    200: (8, 25, 30, 3),
}
BLOCK_INPLANES = (32, 64, 128, 256)
EXPANSION = 4
DS_STRIDE = ((2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4), each conv followed by its norm
    (+ LeakyReLU on the first two), plus the residual, then LeakyReLU
    (reference resnet.py:82-126)."""

    def __init__(self, cin: int, planes: int, stride=1, norm_name: str = "instance",
                 dtype=torch.float32, device=None):
        super().__init__()
        cout = planes * EXPANSION
        s = _triple(stride)
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv3d(cin, planes, 1, 1, **kw)
        self.norm1 = ConvNorm(planes, norm_name, act=True, device=device)
        self.conv2 = Conv3d(planes, planes, 3, s, **kw)
        self.norm2 = ConvNorm(planes, norm_name, act=True, device=device)
        self.conv3 = Conv3d(planes, cout, 1, 1, **kw)
        self.norm3 = ConvNorm(cout, norm_name, device=device)
        self.downsample = None
        if any(v != 1 for v in s) or cin != cout:
            self.downsample = nn.Sequential(Conv3d(cin, cout, 1, s, **kw),
                                            ConvNorm(cout, norm_name, device=device))

    def forward(self, x):
        out = self.norm1(self.conv1(x))
        out = self.norm2(self.conv2(out))
        if self.downsample is None:
            return self.norm3.tail(self.conv3(out), x)
        conv, norm = self.downsample
        return self.norm3.tail(self.conv3(out), conv(x), norm)


class ResNet3D(nn.Module):
    """Four-stage bottleneck encoder; ``forward`` returns the stage pyramid
    [enc1, enc2, enc3, enc4]."""

    def __init__(self, model_depth: int = 101,
                 ds_stride: Sequence[Tuple[int, int, int]] = DS_STRIDE, conv1_t_size: int = 7,
                 in_channels: int = 1, in_stem: int = 64, norm_name: str = "instance",
                 dtype=torch.float32, device=None):
        super().__init__()
        if model_depth not in LAYER_COUNTS:
            raise ValueError(f"model_depth must be one of {sorted(LAYER_COUNTS)}, got {model_depth}")
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv3d(in_channels, in_stem, (7, 7, conv1_t_size), ds_stride[0], **kw)
        self.norm1 = ConvNorm(in_stem, norm_name, act=True, device=device)
        cin = in_stem
        strides = (1, *ds_stride[1:])
        for stage, (planes, blocks, stride) in enumerate(
                zip(BLOCK_INPLANES, LAYER_COUNTS[model_depth], strides), start=1):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(cin, planes, stride if b == 0 else 1, norm_name, **kw))
                cin = planes * EXPANSION
            self.add_module(f"layer{stage}", nn.Sequential(*layer))

    def forward(self, x):
        h = self.norm1(self.conv1(x))
        features = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            for i, block in enumerate(stage):  # after the first, the JAX remat-scanned tail
                h = maybe_remat(block, h) if i else block(h)
            features.append(h)
        return features
