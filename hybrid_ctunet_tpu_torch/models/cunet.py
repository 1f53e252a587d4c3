"""CUNet — pure-CNN 3D U-Net: ResNet bottleneck encoder + transposed-conv
decoder with deep supervision. Port of ``hybrid_ctunet_tpu/models/cunet.py``
(reference CUNet, hybrid_CTUNet.py:859-937).

``forward`` returns (res@full, res@48x48x96, res@24x24x48) channels-last.
50,779,754 params at depth 101: the reference's 50,783,850 less the 4,096
of res_decoder0's dead ``conv3``.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import UnetOutHead, UpCatConvBlock, UpConvBlock
from .resnet3d import DS_STRIDE, ResNet3D

DIMS = (128, 256, 512, 1024)


class CUNet(nn.Module):
    def __init__(self, out_channels: int = 14, model_depth: int = 101, in_channels: int = 1,
                 norm_name: str = "instance", dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        nkw = dict(norm_name=norm_name, **kw)
        self.convnet = ResNet3D(model_depth, DS_STRIDE, in_channels=in_channels, **nkw)
        self.res_decoder3 = UpCatConvBlock(DIMS[3], DIMS[2], DS_STRIDE[3], **nkw)
        self.res_decoder2 = UpCatConvBlock(DIMS[2], DIMS[1], DS_STRIDE[2], **nkw)
        self.res_decoder1 = UpCatConvBlock(DIMS[1], DIMS[0], DS_STRIDE[1], **nkw)
        self.res_decoder0 = UpConvBlock(DIMS[0], 64, DS_STRIDE[0], **nkw)
        self.res_out = UnetOutHead(64, out_channels, **kw)
        self.res_out_48x48 = UnetOutHead(DIMS[0], out_channels, **kw)
        self.res_out_24x24 = UnetOutHead(DIMS[1], out_channels, **kw)

    def forward(self, x):
        enc1, enc2, enc3, enc4 = self.convnet(x)
        dec3 = self.res_decoder3(enc4, enc3)
        dec2 = self.res_decoder2(dec3, enc2)
        dec1 = self.res_decoder1(dec2, enc1)
        out = self.res_decoder0(dec1)
        return self.res_out(out), self.res_out_48x48(dec1), self.res_out_24x24(dec2)
