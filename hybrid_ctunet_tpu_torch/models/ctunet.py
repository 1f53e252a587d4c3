"""CTUNet — the TUNet ViT pyramid and a ResNet encoder, fused per decoder
level by pixelweight attention. Port of ``hybrid_ctunet_tpu/models/ctunet.py``
(reference CTUNet, hybrid_CTUNet.py:694-857), without the 6x6x12-level
fusion, which the reference comments out.

The reference's state dict holds the ViT branch at the top level (``vit.*``,
``vit_encoder.*``, ``vit_encoder0.layer.*``, ``vit_decoder0.*``,
``decoder_linear_96x96.head.*``, ``vit_out.*``; ``convert_ctunet`` reads them
there), so CTUNet subclasses TUNetCore rather than holding it as a child.
174,109,542 params at depth 101 / pf 8: the reference's 174,801,766 less the
692,224 of the dead ``conv3`` in the six fusion ResBlocks and res_decoder0.
"""
from __future__ import annotations

import torch

from .layers import UnetOutHead, Up2FusionBlock, UpConvBlock
from .resnet3d import DS_STRIDE, ResNet3D
from .tunet import TUNetCore

DIMS = (128, 256, 512, 1024)


class CTUNet(TUNetCore):
    def __init__(self, out_channels: int = 14, model_depth: int = 101, in_channels: int = 1,
                 norm_name: str = "instance", dtype=torch.float32, device=None,
                 **tunet_kwargs):
        super().__init__(out_channels=out_channels, in_channels=in_channels,
                         norm_name=norm_name, dtype=dtype, device=device, **tunet_kwargs)
        kw = dict(dtype=dtype, device=device)
        nkw = dict(norm_name=norm_name, **kw)
        self.convnet = ResNet3D(model_depth, DS_STRIDE, in_channels=in_channels, **nkw)
        self.res_decoder3 = Up2FusionBlock(DIMS[3], DIMS[2], DS_STRIDE[3], **nkw)
        self.res_decoder2 = Up2FusionBlock(DIMS[2], DIMS[1], DS_STRIDE[2], **nkw)
        self.res_decoder1 = Up2FusionBlock(DIMS[1], DIMS[0], DS_STRIDE[1], **nkw)
        self.res_decoder0 = UpConvBlock(DIMS[0], 64, DS_STRIDE[0], **nkw)
        self.res_out = UnetOutHead(64, out_channels, **kw)
        self.res_out_48x48 = UnetOutHead(DIMS[0], out_channels, **kw)
        self.res_out_24x24 = UnetOutHead(DIMS[1], out_channels, **kw)

    def forward(self, x, res_only: bool = False):
        """((res, res48, res24), (vit, vit96)), channels-last. ``res_only``
        returns the full-resolution res head alone and skips what it does not
        need — the ViT branch's full-resolution stage, conv stem, decoder and
        heads, and the two deep-supervision heads — as the JAX ensemble's
        res-only predictor lets XLA drop them."""
        pyramid = self.pyramid(x, stages=3 if res_only else 4)
        vit_12, vit_24, vit_48 = pyramid[1], pyramid[2], pyramid[3]
        enc1, enc2, enc3, enc4 = self.convnet(x)
        dec3 = self.res_decoder3(enc4, enc3, vit_12)
        dec2 = self.res_decoder2(dec3, enc2, vit_24)
        dec1 = self.res_decoder1(dec2, enc1, vit_48)
        res = self.res_out(self.res_decoder0(dec1))
        if res_only:
            return res
        vit_logits, vit_96 = self.heads(x, pyramid)
        return (res, self.res_out_48x48(dec1), self.res_out_24x24(dec2)), (vit_logits, vit_96)
