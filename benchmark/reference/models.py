"""Plain PyTorch reference of the Hybrid-CTUNet models: CTUNet (ResNet
encoder, ViT pyramid, pixelweight fusion decoder) and TUNet.

A frozen copy of the architecture (Hybrid-CTUNet, github.com/shouwangzhe134/
Hybrid-CTUNet, networks/hybrid_CTUNet.py and networks/resnet.py) written for
the benchmark alone: no kernel, no cache, no batching tricks, every product
in float32. It imports nothing of the program. Tensors are channels-last
(B, X, Y, Z, C); the module and parameter names are the reference's
state-dict keys, so one state dict loads into both this model and the
program's.

Every conv and matrix product goes through an :class:`Arith`: plain float32
for the reference, or with each operand rounded to float8 for the
lower-precision control (e4m3 forward operands, e5m2 gradients, one scale a
tensor). ``Arith.norm_sites`` records the shape of every InstanceNorm call
while ``Arith.recording`` is set (the K8 bound counts them).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

LAYER_COUNTS = {50: (3, 4, 6, 3), 101: (8, 9, 13, 3), 152: (8, 9, 30, 3), 200: (8, 25, 30, 3)}
BLOCK_INPLANES = (32, 64, 128, 256)
EXPANSION = 4
DS_STRIDE = ((2, 2, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2))
DIMS = (128, 256, 512, 1024)


def _fp8_round(t: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``t`` rounded to ``dtype`` under one scale that maps its largest
    magnitude to ``top``, returned in ``t``'s dtype."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((t.float() * scale).to(dtype).float() / scale).to(t.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fp8_round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2, 57344.0)


class Arith:
    """The arithmetic of every conv and matrix product: float32, or each
    operand rounded to float8 first (``fp8``, the control)."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8
        self.recording = False
        self.norm_sites: List[Tuple[int, ...]] = []

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(t) if self.fp8 else t

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def conv(self, x, w, stride):
        """SAME-padded conv (MONAI's padding ``(k - s + 1) // 2``)."""
        pad = tuple((k - s + 1) // 2 for k, s in zip(w.shape[2:], stride))
        y = F.conv3d(self.q(x).permute(0, 4, 1, 2, 3), self.q(w), stride=stride, padding=pad)
        return y.permute(0, 2, 3, 4, 1)

    def conv_transpose(self, x, w, stride):
        """Transposed conv with kernel == stride (every decoder upsample)."""
        y = F.conv_transpose3d(self.q(x).permute(0, 4, 1, 2, 3), self.q(w), stride=stride)
        return y.permute(0, 2, 3, 4, 1)

    def instance_norm(self, x, act: bool):
        """Affine-free InstanceNorm (eps 1e-5) over space [+ LeakyReLU 0.01]."""
        if self.recording:
            self.norm_sites.append(tuple(x.shape))
        y = F.instance_norm(x.permute(0, 4, 1, 2, 3), eps=1e-5).permute(0, 2, 3, 4, 1)
        return F.leaky_relu(y, 0.01) if act else y


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape))


def _triple(v) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


class LayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight, self.bias = _param(dim), _param(dim)

    def forward(self, x):
        return F.layer_norm(x, (x.shape[-1],), self.weight, self.bias, 1e-5)


class Dense(nn.Module):
    def __init__(self, ar, cin, cout, bias=True):
        super().__init__()
        self.ar = ar
        self.weight = _param(cout, cin)
        self.bias = _param(cout) if bias else None

    def forward(self, x):
        y = self.ar.matmul(x, self.weight.t())
        return y + self.bias if self.bias is not None else y


class _ConvWeights(nn.Module):
    def __init__(self, cin, cout, k, bias):
        super().__init__()
        self.weight = _param(cout, cin, *k)
        self.bias = _param(cout) if bias else None


class Conv3d(nn.Module):
    def __init__(self, ar, cin, cout, k=3, stride=1, bias=False):
        super().__init__()
        self.ar, self.stride = ar, _triple(stride)
        self.conv = _ConvWeights(cin, cout, _triple(k), bias)

    def forward(self, x):
        y = self.ar.conv(x, self.conv.weight, self.stride)
        return y + self.conv.bias if self.conv.bias is not None else y


class _TWeight(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.weight = _param(cin, cout, *k)


class ConvTranspose3d(nn.Module):
    def __init__(self, ar, cin, cout, stride):
        super().__init__()
        self.ar, self.stride = ar, _triple(stride)
        self.conv = _TWeight(cin, cout, self.stride)

    def forward(self, x):
        return self.ar.conv_transpose(x, self.conv.weight, self.stride)


class ResBlock(nn.Module):
    """conv-IN-LeakyReLU, conv-IN, + (projected) input, LeakyReLU."""

    def __init__(self, ar, cin, features, stride=1):
        super().__init__()
        self.ar = ar
        self.proj = cin != features or any(s != 1 for s in _triple(stride))
        self.conv1 = Conv3d(ar, cin, features, 3, stride)
        self.conv2 = Conv3d(ar, features, features, 3, 1)
        if self.proj:
            self.conv3 = Conv3d(ar, cin, features, 1, stride)

    def forward(self, x, skip=None):
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        out = self.ar.instance_norm(self.conv1(x), True)
        out = self.ar.instance_norm(self.conv2(out), False)
        res = self.ar.instance_norm(self.conv3(x), False) if self.proj else x
        return F.leaky_relu(out + res, 0.01)


class Bottleneck(nn.Module):
    def __init__(self, ar, cin, planes, stride=1):
        super().__init__()
        self.ar = ar
        cout = planes * EXPANSION
        s = _triple(stride)
        self.conv1 = Conv3d(ar, cin, planes, 1)
        self.conv2 = Conv3d(ar, planes, planes, 3, s)
        self.conv3 = Conv3d(ar, planes, cout, 1)
        self.downsample = None
        if any(v != 1 for v in s) or cin != cout:
            self.downsample = nn.Sequential(Conv3d(ar, cin, cout, 1, s))

    def forward(self, x):
        n = self.ar.instance_norm
        out = n(self.conv1(x), True)
        out = n(self.conv2(out), True)
        out = n(self.conv3(out), False)
        res = x if self.downsample is None else n(self.downsample[0](x), False)
        return F.leaky_relu(out + res, 0.01)


class ResNet3D(nn.Module):
    def __init__(self, ar, depth=101, in_channels=1):
        super().__init__()
        self.ar = ar
        self.conv1 = Conv3d(ar, in_channels, 64, (7, 7, 7), DS_STRIDE[0])
        cin = 64
        for stage, (planes, blocks, stride) in enumerate(
                zip(BLOCK_INPLANES, LAYER_COUNTS[depth], (1, *DS_STRIDE[1:])), start=1):
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(ar, cin, planes, stride if b == 0 else 1))
                cin = planes * EXPANSION
            self.add_module(f"layer{stage}", nn.Sequential(*layer))

    def forward(self, x):
        h = self.ar.instance_norm(self.conv1(x), True)
        feats = []
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            h = stage(h)
            feats.append(h)
        return feats


class FeedForward(nn.Module):
    """x + Linear(GELU(Linear(LN(x)))) (``net`` indices as the reference's)."""

    def __init__(self, ar, dim, hidden):
        super().__init__()
        self.net = nn.Sequential(LayerNorm(dim), Dense(ar, dim, hidden), nn.GELU(),
                                 nn.Identity(), Dense(ar, hidden, dim), nn.Identity())

    def forward(self, x):
        return x + self.net(x)


class Residual(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn


class _Table(nn.Module):
    def __init__(self, rows, cols):
        super().__init__()
        self.weight = _param(rows, cols)


def rel_pos_index(w: int, device=None) -> torch.Tensor:
    """(w^3, w^3) index into the ((2w-1)^3, heads) bias table: tokens in
    (h, w, f) order, sum over axes of (p_i - p_j + w - 1) x the axis stride
    of a (2w-1)^3 grid."""
    s = 2 * w - 1
    pos = torch.arange(w ** 3, device=device)
    coords = torch.stack([pos // (w * w), (pos // w) % w, pos % w], -1)
    d = coords[:, None, :] - coords[None, :, :] + (w - 1)
    return (d[..., 0] * s + d[..., 1]) * s + d[..., 2]


class WindowAttention(nn.Module):
    """Block (``grid=False``) or grid window attention over w^3 windows with
    a relative-position bias, heads of 32."""

    def __init__(self, ar, dim, window, grid):
        super().__init__()
        self.ar, self.window, self.grid = ar, window, grid
        self.heads = dim // 32
        self.norm = LayerNorm(dim)
        self.to_qkv = Dense(ar, dim, 3 * dim, bias=False)
        self.rel_pos_bias = _Table((2 * window - 1) ** 3, self.heads)
        self.to_out = nn.Sequential(Dense(ar, dim, dim, bias=False), nn.Identity())

    def forward(self, x):
        B, X, Y, Z, C = x.shape
        w = self.window
        nx, ny, nz = X // w, Y // w, Z // w
        h = self.norm(x)
        if self.grid:
            h = h.reshape(B, w, nx, w, ny, w, nz, C).permute(0, 2, 4, 6, 1, 3, 5, 7)
        else:
            h = h.reshape(B, nx, w, ny, w, nz, w, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
        T = w ** 3
        h = h.reshape(-1, T, C)
        q, k, v = self.to_qkv(h).split(C, dim=-1)

        def heads(t):
            return t.reshape(t.shape[0], T, self.heads, 32).transpose(1, 2)

        q, k, v = heads(q) * 32 ** -0.5, heads(k), heads(v)
        bias = self.rel_pos_bias.weight[rel_pos_index(w, x.device)].permute(2, 0, 1)
        attn = torch.softmax(self.ar.matmul(q, k.transpose(-1, -2)) + bias, dim=-1)
        out = self.ar.matmul(attn, v).transpose(1, 2).reshape(-1, T, C)
        out = self.to_out(out).reshape(B, nx, ny, nz, w, w, w, C)
        if self.grid:
            out = out.permute(0, 4, 1, 5, 2, 6, 3, 7)
        else:
            out = out.permute(0, 1, 4, 2, 5, 3, 6, 7)
        return out.reshape(B, X, Y, Z, C)


class PixelShuffleLinear(nn.Module):
    """Channels split (C', f0, f1, f2), C' slowest, into a grid f0 x f1 x f2
    finer; then Linear(C' -> features)."""

    def __init__(self, ar, dim, factor, features):
        super().__init__()
        self.factor = tuple(factor)
        self.to_out = Dense(ar, dim // (factor[0] * factor[1] * factor[2]), features)

    def forward(self, x):
        B, X, Y, Z, C = x.shape
        f0, f1, f2 = self.factor
        cp = C // (f0 * f1 * f2)
        h = x.reshape(B, X, Y, Z, cp, f0, f1, f2).permute(0, 1, 5, 2, 6, 3, 7, 4)
        return self.to_out(h.reshape(B, X * f0, Y * f1, Z * f2, cp))


class UpAttentionBlock(nn.Module):
    """The TUNet decoder pyramid: stages 0-2 block and grid attention, each
    with an FFN, then a pixel shuffle; stage 3 two FFNs and a pixel shuffle."""

    def __init__(self, ar, hidden, window):
        super().__init__()
        chain = (hidden, 512, 256, 128, 64)
        factors = DS_STRIDE[::-1]
        stages = []
        for ind, (din, dout) in enumerate(zip(chain[:-1], chain[1:])):
            shuffle = PixelShuffleLinear(ar, din, factors[ind], dout)

            def ff():
                return Residual(FeedForward(ar, din, 4 * din))

            if ind <= 2:
                seq = nn.Sequential(nn.Identity(), Residual(WindowAttention(ar, din, window, False)),
                                    ff(), nn.Identity(), nn.Identity(),
                                    Residual(WindowAttention(ar, din, window, True)), ff(),
                                    nn.Identity(), shuffle)
            else:
                seq = nn.Sequential(nn.Identity(), ff(), ff(), nn.Identity(), shuffle)
            stages.append(nn.ModuleList([seq]))
        self.layers = nn.ModuleList(stages)

    def forward(self, x, stages=4):
        feats = [x]
        for ind, stage in enumerate(self.layers[:stages]):
            seq = stage[0]
            if ind <= 2:
                x = x + seq[1].fn(x)
                x = seq[2].fn(x)
                x = x + seq[5].fn(x)
                x = seq[6].fn(x)
                x = seq[8](x)
            else:
                x = seq[4](seq[2].fn(seq[1].fn(x)))
            feats.append(x)
        return feats


class ViTAttention(nn.Module):
    def __init__(self, ar, dim, heads):
        super().__init__()
        self.ar, self.heads = ar, heads
        self.norm = LayerNorm(dim)
        self.to_qkv = Dense(ar, dim, 3 * heads * 64, bias=False)
        self.to_out = nn.Sequential(Dense(ar, heads * 64, dim), nn.Identity())

    def forward(self, x):
        B, N, _ = x.shape
        inner = self.heads * 64
        q, k, v = (t.reshape(B, N, self.heads, 64).transpose(1, 2)
                   for t in self.to_qkv(self.norm(x)).split(inner, dim=-1))
        attn = torch.softmax(self.ar.matmul(q * 64 ** -0.5, k.transpose(-1, -2)), dim=-1)
        out = self.ar.matmul(attn, v).transpose(1, 2).reshape(B, N, inner)
        return self.to_out(out)


class TransformerBlock(nn.Module):
    def __init__(self, ar, dim, heads, mlp):
        super().__init__()
        self.attn = ViTAttention(ar, dim, heads)
        self.ff = FeedForward(ar, dim, mlp)

    def forward(self, x):
        return self.ff(self.attn(x) + x)


class ViT3D(nn.Module):
    """Patches of 16 x 16 x pf, tokens in (h w f) order, features
    (p1 p2 pf c); LN-Linear-LN embedding plus a learned position embedding;
    pre-norm blocks."""

    def __init__(self, ar, roi, pf, in_channels, hidden, depth, heads, mlp):
        super().__init__()
        self.patch = (16, 16, pf)
        self.grid = (roi[0] // 16, roi[1] // 16, roi[2] // pf)
        patch_dim = in_channels * 16 * 16 * pf
        self.to_patch_embedding = nn.Sequential(nn.Identity(), LayerNorm(patch_dim),
                                                Dense(ar, patch_dim, hidden), LayerNorm(hidden))
        self.pos_embedding = _param(1, self.grid[0] * self.grid[1] * self.grid[2], hidden)
        self.transformer = nn.ModuleList(TransformerBlock(ar, hidden, heads, mlp)
                                         for _ in range(depth))

    def forward(self, x):
        B, X, Y, Z, C = x.shape
        p1, p2, pf = self.patch
        gh, gw, gf = X // p1, Y // p2, Z // pf
        t = x.reshape(B, gh, p1, gw, p2, gf, pf, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
        t = self.to_patch_embedding(t.reshape(B, gh * gw * gf, p1 * p2 * pf * C))
        t = t + self.pos_embedding
        for block in self.transformer:
            t = block(t)
        return t


class _Holder(nn.Module):
    def __init__(self, **children):
        super().__init__()
        for name, mod in children.items():
            self.add_module(name, mod)


class CatConvBlock(nn.Module):
    def __init__(self, ar, cin, features):
        super().__init__()
        self.conv_block = ResBlock(ar, cin, features)

    def forward(self, x, skip):
        return self.conv_block(x, skip)


class UnetOutHead(nn.Module):
    def __init__(self, ar, cin, cout):
        super().__init__()
        self.conv = Conv3d(ar, cin, cout, 1, bias=True)

    def forward(self, x):
        return self.conv(x)


class TUNetCore(nn.Module):
    def __init__(self, ar, out_channels=14, in_channels=1, roi=(96, 96, 96), patch_frame=8,
                 hidden_size=768, num_depths=12, mlp_dim=3072, num_heads=12, window=6,
                 stem=64):
        super().__init__()
        self.ar = ar
        self.hidden = hidden_size
        self.vit = ViT3D(ar, roi, patch_frame, in_channels, hidden_size, num_depths, num_heads,
                         mlp_dim)
        self.vit_encoder = UpAttentionBlock(ar, hidden_size, window)
        self.vit_encoder0 = _Holder(layer=ResBlock(ar, in_channels, stem))
        self.vit_decoder0 = CatConvBlock(ar, 64 + stem, stem)
        self.vit_out = UnetOutHead(ar, stem, out_channels)
        self.decoder_linear_96x96 = _Holder(head=Dense(ar, 64, out_channels))

    def pyramid(self, x, stages=4):
        grid = self.vit(x).reshape(x.shape[0], *self.vit.grid, self.hidden)
        return self.vit_encoder(grid, stages)

    def heads(self, x, pyramid):
        fused = self.vit_decoder0(pyramid[-1], self.vit_encoder0.layer(x))
        return self.vit_out(fused), self.decoder_linear_96x96.head(pyramid[-1])


class TUNet(TUNetCore):
    """(vit logits, vit 96 logits)."""

    def forward(self, x):
        pyramid = self.pyramid(x)
        return self.heads(x, pyramid)


class PixelweightFusion(nn.Module):
    """Two-way softmax over (q2.k1, q1.k2) per head of 32, mixing v1 and v2."""

    def __init__(self, ar, dim):
        super().__init__()
        self.ar = ar
        self.norm1, self.norm2 = LayerNorm(dim), LayerNorm(dim)
        self.to_qkv1 = Dense(ar, dim, 3 * dim, bias=False)
        self.to_qkv2 = Dense(ar, dim, 3 * dim, bias=False)
        self.to_out = nn.Sequential(Dense(ar, dim, dim, bias=False), nn.Identity())

    def forward(self, x1, x2):
        C = x1.shape[-1]
        heads = C // 32
        split = [t.reshape(*t.shape[:-1], heads, 32)
                 for t in (*self.to_qkv1(self.norm1(x1)).split(C, -1),
                           *self.to_qkv2(self.norm2(x2)).split(C, -1))]
        q1, k1, v1, q2, k2, v2 = split
        scale = 32 ** -0.5
        d1 = (self.ar.q(q2) * self.ar.q(k1)).sum(-1) * scale
        d2 = (self.ar.q(q1) * self.ar.q(k2)).sum(-1) * scale
        w = torch.softmax(torch.stack([d1, d2], -1), -1)
        out = w[..., 0:1] * v1 + w[..., 1:2] * v2
        return self.to_out(out.reshape(x1.shape))


class Up2FusionBlock(nn.Module):
    def __init__(self, ar, cin, features, stride):
        super().__init__()
        self.pixelweight_attention1 = PixelweightFusion(ar, features)
        self.up_addconv_block1 = ResBlock(ar, features, features)
        self.transp_conv = ConvTranspose3d(ar, cin, features, stride)
        self.pixelweight_attention2 = PixelweightFusion(ar, features)
        self.up_addconv_block2 = ResBlock(ar, features, features)

    def forward(self, x, skip_conv, skip_vit):
        skip = self.up_addconv_block1(self.pixelweight_attention1(skip_conv, skip_vit))
        return self.up_addconv_block2(self.pixelweight_attention2(self.transp_conv(x), skip))


class UpConvBlock(nn.Module):
    def __init__(self, ar, cin, features, stride):
        super().__init__()
        self.transp_conv = ConvTranspose3d(ar, cin, features, stride)
        self.conv_block = ResBlock(ar, features, features)

    def forward(self, x):
        return self.conv_block(self.transp_conv(x))


class CTUNet(TUNetCore):
    """((res, res 48, res 24), (vit, vit 96)); ``res_only`` returns the res
    head alone and runs only what it needs (the ensemble's predictor)."""

    def __init__(self, ar, out_channels=14, model_depth=101, in_channels=1, **tunet):
        super().__init__(ar, out_channels=out_channels, in_channels=in_channels, **tunet)
        self.convnet = ResNet3D(ar, model_depth, in_channels)
        self.res_decoder3 = Up2FusionBlock(ar, DIMS[3], DIMS[2], DS_STRIDE[3])
        self.res_decoder2 = Up2FusionBlock(ar, DIMS[2], DIMS[1], DS_STRIDE[2])
        self.res_decoder1 = Up2FusionBlock(ar, DIMS[1], DIMS[0], DS_STRIDE[1])
        self.res_decoder0 = UpConvBlock(ar, DIMS[0], 64, DS_STRIDE[0])
        self.res_out = UnetOutHead(ar, 64, out_channels)
        self.res_out_48x48 = UnetOutHead(ar, DIMS[0], out_channels)
        self.res_out_24x24 = UnetOutHead(ar, DIMS[1], out_channels)

    def forward(self, x, res_only: bool = False):
        pyramid = self.pyramid(x, stages=3 if res_only else 4)
        enc1, enc2, enc3, enc4 = self.convnet(x)
        dec3 = self.res_decoder3(enc4, enc3, pyramid[1])
        dec2 = self.res_decoder2(dec3, enc2, pyramid[2])
        dec1 = self.res_decoder1(dec2, enc1, pyramid[3])
        res = self.res_out(self.res_decoder0(dec1))
        if res_only:
            return res
        return (res, self.res_out_48x48(dec1), self.res_out_24x24(dec2)), self.heads(x, pyramid)


def build(kind: str, sizes: dict, ar: Arith, device=None) -> nn.Module:
    """The reference model ``kind`` ("ctunet" or "tunet") at ``sizes`` (a
    configuration file's ``model`` group), parameters uninitialized on
    ``device``."""
    tunet = dict(roi=tuple(sizes["roi"]), patch_frame=sizes["patch_frame"],
                 hidden_size=sizes["hidden_size"], num_depths=sizes["num_depths"],
                 mlp_dim=sizes["mlp_dim"], num_heads=sizes["num_heads"], window=sizes["window"],
                 stem=sizes["feature_size"])
    with torch.device(device or "cpu"):
        if kind == "ctunet":
            model = CTUNet(ar, sizes["out_channels"], sizes["model_depth"], sizes["in_channels"],
                           **tunet)
        elif kind == "tunet":
            model = TUNet(ar, sizes["out_channels"], sizes["in_channels"], **tunet)
        else:
            raise ValueError(f"unknown model {kind!r}")
    return model


def window_predictor(model: nn.Module, kind: str, res_only: bool):
    """What a sliding-window engine calls a chunk of windows with: the res
    head of a CTUNet (``res_only``) or the vit head of a TUNet."""
    if kind == "ctunet" and res_only:
        return lambda x: model(x, res_only=True)
    if kind == "tunet":
        return lambda x: model(x)[0]
    raise ValueError(f"no window predictor for {kind!r} (res_only={res_only})")


def parameter_shapes(model: nn.Module) -> Sequence[Tuple[str, Tuple[int, ...]]]:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]
