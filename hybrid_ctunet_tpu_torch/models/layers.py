"""Parameterized layers, channels-last NDHWC. Port of the plain-layout
branches of ``hybrid_ctunet_tpu/models/layers.py``.

Attribute names reproduce the reference PyTorch state-dict keys (MONAI
``Convolution.conv``, ``Sequential`` indices), so a reference checkpoint or
``utils.params.tunet_state_dict_from_jax`` loads with ``load_state_dict``.
Params are fp32; ``dtype`` is the compute dtype each op casts them to, as
the JAX modules do (``w.astype(self.dtype)``). Parameters are created empty
on ``device``; ``utils.params.random_init_`` or ``load_state_dict`` fills
them.

Dropout (``dropout`` > 0) sits where the JAX package puts it. A site drops
only in train mode; there it takes its plain version with the masks applied
where JAX applies them, and elsewhere its kernel as without dropout, so no
kernel takes a mask. The masks come from the generator that
:func:`set_dropout_generator` gives the model's :class:`Dropout` modules.

Rematerialization (``maybe_remat``, the JAX ``models/layers.py:80,97-107``,
on by default) wraps exactly the JAX package's sites: every decoder
``ResBlock``, the TUNet stem ``ResBlock``, every ViT block and each ResNet
stage's bottlenecks after the first. A wrapped block's activations are
recomputed in the backward, its dropout masks drawn again from the same
generator state and its BatchNorm buffers updated once.
"""
from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops import attention as attention_ops
from ..ops import dropout as dropout_ops
from ..ops import ffn as ffn_ops
from ..ops import norm as norm_ops
from ..ops import pixelweight as pixelweight_ops
from ..ops import recompute as recompute_ops
from ..ops import shuffle as shuffle_ops
from ..ops.act import leaky_relu
from ..ops.conv import _triple, conv3d_same, conv_transpose3d_same
from ..ops.norm import layer_norm


def _empty(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, dtype=torch.float32, device=device))


def instance_norm_act(x: torch.Tensor, act: bool = False) -> torch.Tensor:
    """The conv-path epilogue, InstanceNorm [+ LeakyReLU 0.01]: ops.norm's
    kernel (K8) where its gate takes the tensor (bf16), the plain version
    elsewhere."""
    if norm_ops.supports(x):
        return norm_ops.instance_norm_leaky(x) if act else norm_ops.instance_norm(x)
    y = norm_ops.reference_instance_norm(x)
    return leaky_relu(y) if act else y


class Dropout(nn.Module):
    """One dropout site: active when ``rate`` > 0 in train mode, the
    identity otherwise. Draws from ``generator`` (set by
    :func:`set_dropout_generator`); owns no state-dict entry."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator = None

    def active(self) -> bool:
        return self.rate > 0.0 and self.training

    def forward(self, x):
        if not self.active():
            return x
        if self.generator is None and self.rate < 1.0:
            raise RuntimeError("dropout is active and no generator is set: call "
                               "models.layers.set_dropout_generator(model, generator)")
        return dropout_ops.dropout(x, self.rate, self.generator)


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Every dropout site of ``model`` draws from ``generator`` (a
    ``torch.Generator`` on the model's device)."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


_REMAT_BLOCKS = True


def set_remat_blocks(enabled: bool) -> None:
    """Global switch for block-level rematerialization, read at each call.
    On by default, as in the JAX package: a wrapped block keeps only its
    inputs for the backward and runs its forward again there. The eval and
    bench entries switch it off."""
    global _REMAT_BLOCKS
    _REMAT_BLOCKS = bool(enabled)


@contextlib.contextmanager
def remat_blocks(enabled: bool):
    """The switch set to ``enabled`` while the context stands."""
    before = _REMAT_BLOCKS
    set_remat_blocks(enabled)
    try:
        yield
    finally:
        set_remat_blocks(before)


def remat(module: nn.Module, *args):
    """``module(*args)``, its activations recomputed in the backward
    (``ops.recompute.checkpoint``), the generators of its active dropout
    sites replayed there."""
    generators = {id(m.generator): m.generator for m in module.modules()
                  if isinstance(m, Dropout) and m.active() and m.generator is not None}
    return recompute_ops.checkpoint(module, *args, generators=list(generators.values()))


def maybe_remat(module: nn.Module, *args):
    """``module(*args)``: rematerialized (:func:`remat`) while the switch is
    on and autograd records, called directly otherwise, so that inference
    pays nothing."""
    if _REMAT_BLOCKS and torch.is_grad_enabled():
        return remat(module, *args)
    return module(*args)


class ConvNorm(nn.Module):
    """The norm after a conv, ``--norm_name`` (the JAX ``apply_norm``,
    ``models/layers.py:52``), + LeakyReLU 0.01 when ``act``.

    ``"instance"``: affine-free InstanceNorm (K8 where its gate takes the
    tensor); owns nothing, so the state dict is the reference's default.
    ``"batch"``: BatchNorm3d with eps 1e-5, momentum 0.1, an affine
    (``weight``, ``bias``) and the buffers ``running_mean``, ``running_var``
    and ``num_batches_tracked``; plain PyTorch (``ops.norm.batch_norm``).
    Under a process group of more than one rank,
    :func:`convert_sync_batchnorm` sets ``sync``: the moments are then
    summed over the group first (SyncBatchNorm, the JAX ``"batch:data"``)."""

    def __init__(self, channels: int, norm_name: str = "instance", act: bool = False,
                 device=None):
        super().__init__()
        if norm_name not in ("instance", "batch"):
            raise ValueError(f"unsupported norm {norm_name!r}: expected 'instance' or 'batch'")
        self.kind, self.sync, self.act = norm_name, False, act
        if norm_name == "batch":
            f32 = dict(dtype=torch.float32, device=device)
            self.weight = nn.Parameter(torch.ones(channels, **f32))
            self.bias = nn.Parameter(torch.zeros(channels, **f32))
            self.register_buffer("running_mean", torch.zeros(channels, **f32))
            self.register_buffer("running_var", torch.ones(channels, **f32))
            self.register_buffer("num_batches_tracked",
                                 torch.zeros((), dtype=torch.long, device=device))

    def forward(self, x):
        if self.kind == "instance":
            return instance_norm_act(x, self.act)
        y = norm_ops.batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                                training=self.training, sync=self.sync)
        if self.training and not recompute_ops.recomputing():
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
        return leaky_relu(y) if self.act else y


def convert_sync_batchnorm(model: nn.Module) -> nn.Module:
    """Every BatchNorm of ``model`` syncs its moments over the process group
    (the reference's ``nn.SyncBatchNorm.convert_sync_batchnorm``,
    main_C_TUNet.py:193-194); instance norms are left as they are."""
    for m in model.modules():
        if isinstance(m, ConvNorm) and m.kind == "batch":
            m.sync = True
    return model


class Dense(nn.Module):
    """Linear in torch layout (``weight`` (out, in), ``bias`` (out)):
    ``y = dtype(x @ w^T) + dtype(b)`` — fp32 accumulation rounded to the
    compute dtype before the bias add, like the JAX Dense."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _empty(out_features, in_features, device=device)
        self.bias = _empty(out_features, device=device) if bias else None

    def forward(self, x):
        y = torch.matmul(x.to(self.dtype), self.weight.to(self.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """Torch-parity LayerNorm (eps 1e-5, affine, fp32 internals); returns the
    input's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = _empty(dim, device=device)
        self.bias = _empty(dim, device=device)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class Conv3dWeights(nn.Module):
    """Holder of a Conv3d's ``weight`` (Cout, Cin, k, k, k) and optional
    ``bias`` — the ``.conv`` of MONAI's Convolution."""

    def __init__(self, cin: int, cout: int, kernel_size, bias: bool, device=None):
        super().__init__()
        self.weight = _empty(cout, cin, *_triple(kernel_size), device=device)
        self.bias = _empty(cout, device=device) if bias else None


class _Weight(nn.Module):
    """Holder of one bias-free ``weight`` — the ``.conv`` of MONAI's
    transposed Convolution."""

    def __init__(self, *shape, device=None):
        super().__init__()
        self.weight = _empty(*shape, device=device)


class Conv3d(nn.Module):
    """SAME-padded 3D conv over NDHWC (bias optional; the reference's convs
    are bias-free except the 1x1x1 output heads). Key: ``conv.weight``."""

    def __init__(self, cin: int, cout: int, kernel_size=3, stride=1, bias: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.stride = _triple(stride)
        self.dtype = dtype
        self.conv = Conv3dWeights(cin, cout, kernel_size, bias, device=device)

    def forward(self, x):
        y = conv3d_same(x.to(self.dtype), self.conv.weight.to(self.dtype), self.stride)
        if self.conv.bias is not None:
            y = y + self.conv.bias.to(self.dtype)
        return y


class FeedForward(nn.Module):
    """LN -> Linear(mult*dim) -> GELU -> Linear(dim), optionally residual
    (reference FeedForward, hybrid_CTUNet.py:513-526 / vit.py:31-44).
    ``net`` indices follow the reference's Sequential: 0 LayerNorm, 1 Linear,
    2 GELU, 3 Dropout, 4 Linear, 5 Dropout. In bf16 with hidden <= 1024 it
    goes through ops.ffn (the fused kernel for CUDA tensors), elsewhere, and
    wherever dropout is active, the plain version."""

    def __init__(self, dim: int, hidden: int, residual: bool = False, dropout: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.residual = residual
        self.net = nn.Sequential(
            LayerNorm(dim, device=device),
            Dense(dim, hidden, dtype=dtype, device=device),
            nn.GELU(),
            Dropout(dropout),
            Dense(hidden, dim, dtype=dtype, device=device),
            Dropout(dropout),
        )

    def params(self) -> Tuple[torch.Tensor, ...]:
        """(ln_w, ln_b, w1, b1, w2, b2) in torch layout."""
        n = self.net
        return (n[0].weight, n[0].bias, n[1].weight, n[1].bias, n[4].weight, n[4].bias)

    def dropping(self) -> bool:
        return self.net[3].active()

    def forward(self, x):
        p = self.params()
        if self.dropping():
            # JAX models/layers.py:287-299: after GELU and after fc2
            out = ffn_ops.reference_ffn(x, *p, self.dtype, hidden_dropout=self.net[3],
                                        out_dropout=self.net[5])
        elif ffn_ops.supports(x.shape[-1], p[2].shape[0], self.dtype):
            return ffn_ops.ffn(x, *p, self.dtype, residual=self.residual)
        else:
            out = ffn_ops.reference_ffn(x, *p, self.dtype)
        return x + out if self.residual else out


class Residual(nn.Module):
    """Holder with the reference's ``Residual.fn`` key; callers add x."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


class _Table(nn.Module):
    """Holder of the ``rel_pos_bias.weight`` table (an nn.Embedding in the
    reference)."""

    def __init__(self, rows: int, cols: int, device=None):
        super().__init__()
        self.weight = _empty(rows, cols, device=device)


class MultiAxisWindowAttention(nn.Module):
    """MaxViT-style windowed MHSA over w^3 windows with a 3D relative-position
    bias (reference MultiAxisAttention, hybrid_CTUNet.py:442-511).

    ``grid=False``: block attention over contiguous w^3 windows.
    ``grid=True``: grid attention across windows at a fixed intra-window
    offset (the reference's '(h1 h)' rearrange). The partition is plain
    reshape/permute; the attention core is ops.attention (a kernel on CUDA
    in bf16). With dropout active the core is the plain version with the
    mask on the softmaxed scores, and ``to_out`` drops too."""

    def __init__(self, dim: int, window: int = 6, grid: bool = False, dim_head: int = 32,
                 dropout: float = 0.0, dtype=torch.float32, device=None):
        super().__init__()
        self.window, self.grid, self.dim_head, self.dtype = window, grid, dim_head, dtype
        self.heads = dim // dim_head
        self.norm = LayerNorm(dim, device=device)
        self.to_qkv = Dense(dim, 3 * dim, bias=False, dtype=dtype, device=device)
        self.rel_pos_bias = _Table((2 * window - 1) ** 3, self.heads, device=device)
        self.drop_attn = Dropout(dropout)
        self.to_out = nn.Sequential(Dense(dim, dim, bias=False, dtype=dtype, device=device),
                                    Dropout(dropout))

    def forward(self, x):
        B, X, Y, Z, C = x.shape
        w = self.window
        if X % w or Y % w or Z % w:
            raise ValueError(f"spatial dims {(X, Y, Z)} must be divisible by window {w}")
        nx, ny, nz = X // w, Y // w, Z // w
        h = self.norm(x)
        if not self.grid:
            h = h.reshape(B, nx, w, ny, w, nz, w, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
        else:
            h = h.reshape(B, w, nx, w, ny, w, nz, C).permute(0, 2, 4, 6, 1, 3, 5, 7)
        T = w * w * w
        h = h.reshape(B * nx * ny * nz, T, C)

        qkv = self.to_qkv(h)
        q, k, v = qkv.split(C, dim=-1)
        q = q * self.dim_head ** -0.5
        table = self.rel_pos_bias.weight  # ((2w-1)^3, heads), gathered by the op
        if self.drop_attn.active():  # JAX models/layers.py:396-407
            out = attention_ops.reference_window_attention_table(
                q, k, v, table, w, self.dtype, attn_dropout=self.drop_attn)
        elif attention_ops.supports(T, C, self.heads, self.dtype):
            out = attention_ops.window_attention(q, k, v, table, w, self.dtype)
        else:
            out = attention_ops.reference_window_attention_table(q, k, v, table, w, self.dtype)
        out = self.to_out(out)

        out = out.reshape(B, nx, ny, nz, w, w, w, C)
        if not self.grid:
            out = out.permute(0, 1, 4, 2, 5, 3, 6, 7)
        else:
            out = out.permute(0, 4, 1, 5, 2, 6, 3, 7)
        return out.reshape(B, X, Y, Z, C)


class PixelShuffleLinear(nn.Module):
    """Anisotropic 3D pixel shuffle + per-voxel Linear (reference
    PixelShuffle, hybrid_CTUNet.py:388-432): channels split as
    (C', f0, f1, f2), C' slowest; then Linear(C' -> features). On CUDA in
    bf16 it runs the fused kernel (ops.shuffle)."""

    def __init__(self, dim: int, factor: Sequence[int], features: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.factor = tuple(int(f) for f in factor)
        self.dtype = dtype
        div = self.factor[0] * self.factor[1] * self.factor[2]
        if dim % div:
            raise ValueError(f"channels {dim} not divisible by prod(factor) {div}")
        self.to_out = Dense(dim // div, features, dtype=dtype, device=device)

    def forward(self, x):
        w, b = self.to_out.weight, self.to_out.bias
        if shuffle_ops.supports(x.shape[-1], self.factor, w.shape[0], self.dtype):
            return shuffle_ops.pixel_shuffle_linear(x, w, b, self.factor, self.dtype)
        return shuffle_ops.reference_shuffle(x, w, b, self.factor, self.dtype)


class ResBlock(nn.Module):
    """2-conv residual block with a norm (``norm_name``) and LeakyReLU(0.01),
    and a 1x1x1 projection shortcut when the shape changes (reference
    hybrid_CTUNet.py:29-105). ``forward(x, skip)`` runs on
    ``cat([x, skip], -1)``. The reference's conv3, dead when in == out and
    stride 1, is not built. Norms ``norm1``, ``norm2``, ``norm3`` (the JAX
    names)."""

    def __init__(self, cin: int, features: int, kernel_size=3, stride=1,
                 norm_name: str = "instance", dtype=torch.float32, device=None):
        super().__init__()
        self.needs_proj = cin != features or any(s != 1 for s in _triple(stride))
        self.conv1 = Conv3d(cin, features, kernel_size, stride, dtype=dtype, device=device)
        self.norm1 = ConvNorm(features, norm_name, act=True, device=device)
        self.conv2 = Conv3d(features, features, kernel_size, 1, dtype=dtype, device=device)
        self.norm2 = ConvNorm(features, norm_name, device=device)
        if self.needs_proj:
            self.conv3 = Conv3d(cin, features, 1, stride, dtype=dtype, device=device)
            self.norm3 = ConvNorm(features, norm_name, device=device)

    def forward(self, x, skip=None):
        if skip is not None:
            x = torch.cat([x, skip.to(x.dtype)], dim=-1)
        out = self.norm1(self.conv1(x))
        out = self.norm2(self.conv2(out))
        residual = self.norm3(self.conv3(x)) if self.needs_proj else x
        return leaky_relu(out + residual)


class ConvTranspose3d(nn.Module):
    """Bias-free SAME transposed conv; every reference use has kernel ==
    stride (the K6 GEMM in ops.shuffle). Key ``conv.weight`` in torch's
    (Cin, Cout, k0, k1, k2) layout."""

    def __init__(self, cin: int, cout: int, kernel_size, stride, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.stride = _triple(stride)
        self.dtype = dtype
        self.conv = _Weight(cin, cout, *_triple(kernel_size), device=device)

    def forward(self, x):
        # the weight goes in as held: K6 and the plain version cast it to the
        # compute dtype themselves
        return conv_transpose3d_same(x.to(self.dtype), self.conv.weight, self.stride)


class PixelweightFusion(nn.Module):
    """Binary cross-weight attention fusing two same-shape streams (reference
    pixelweight_attention, hybrid_CTUNet.py:622-669). Keys ``norm1``,
    ``norm2``, ``to_qkv1``, ``to_qkv2``, ``to_out.0``, all projections
    bias-free. In bf16 it runs ops.pixelweight (K7 on CUDA tensors). With
    dropout active (JAX ``models/layers.py:564-575``) the plain version
    drops the 2-way weights and the output; no CTUNet caller sets a rate,
    as in the reference."""

    def __init__(self, dim: int, dim_head: int = 32, dropout: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dim_head, self.dtype = dim_head, dtype
        self.norm1 = LayerNorm(dim, device=device)
        self.norm2 = LayerNorm(dim, device=device)
        self.to_qkv1 = Dense(dim, 3 * dim, bias=False, dtype=dtype, device=device)
        self.to_qkv2 = Dense(dim, 3 * dim, bias=False, dtype=dtype, device=device)
        self.drop_attn = Dropout(dropout)
        self.to_out = nn.Sequential(Dense(dim, dim, bias=False, dtype=dtype, device=device),
                                    Dropout(dropout))

    def forward(self, x1, x2):
        p = (self.norm1.weight, self.norm1.bias, self.norm2.weight, self.norm2.bias,
             self.to_qkv1.weight, self.to_qkv2.weight, self.to_out[0].weight)
        x1, x2 = x1.to(self.dtype), x2.to(self.dtype)
        if self.drop_attn.active():
            return pixelweight_ops.reference_pixelweight(
                x1, x2, p, self.dtype, self.dim_head, attn_dropout=self.drop_attn,
                out_dropout=self.to_out[1])
        if pixelweight_ops.supports(x1.shape[-1], self.dtype, self.dim_head):
            return pixelweight_ops.pixelweight(x1, x2, p, self.dtype, self.dim_head)
        return pixelweight_ops.reference_pixelweight(x1, x2, p, self.dtype, self.dim_head)


class UpCatConvBlock(nn.Module):
    """Transposed-conv upsample -> concat skip -> ResBlock (reference
    UpCatConvBlock, hybrid_CTUNet.py:148-201)."""

    def __init__(self, cin: int, features: int, upsample_stride, kernel_size: int = 3,
                 norm_name: str = "instance", dtype=torch.float32, device=None):
        super().__init__()
        s = _triple(upsample_stride)
        self.transp_conv = ConvTranspose3d(cin, features, s, s, dtype=dtype, device=device)
        self.conv_block = ResBlock(2 * features, features, kernel_size, 1, norm_name,
                                   dtype=dtype, device=device)

    def forward(self, x, skip):
        return maybe_remat(self.conv_block, self.transp_conv(x), skip)


class UpConvBlock(nn.Module):
    """Transposed-conv upsample -> ResBlock, no skip (reference UpConvBlock,
    hybrid_CTUNet.py:203-255)."""

    def __init__(self, cin: int, features: int, upsample_stride, kernel_size: int = 3,
                 norm_name: str = "instance", dtype=torch.float32, device=None):
        super().__init__()
        s = _triple(upsample_stride)
        self.transp_conv = ConvTranspose3d(cin, features, s, s, dtype=dtype, device=device)
        self.conv_block = ResBlock(features, features, kernel_size, 1, norm_name,
                                   dtype=dtype, device=device)

    def forward(self, x):
        return maybe_remat(self.conv_block, self.transp_conv(x))


class Up2FusionBlock(nn.Module):
    """CTUNet fusion decoder stage, the reference's active "fusion2" forward
    (hybrid_CTUNet.py:329-341): pixelweight-fuse(skip_conv, skip_vit) ->
    ResBlock; transposed conv of x; pixelweight-fuse(that, skip) -> ResBlock."""

    def __init__(self, cin: int, features: int, upsample_stride, kernel_size: int = 3,
                 norm_name: str = "instance", dtype=torch.float32, device=None):
        super().__init__()
        s = _triple(upsample_stride)
        kw = dict(dtype=dtype, device=device)
        self.pixelweight_attention1 = PixelweightFusion(features, **kw)
        self.up_addconv_block1 = ResBlock(features, features, kernel_size, 1, norm_name, **kw)
        self.transp_conv = ConvTranspose3d(cin, features, s, s, **kw)
        self.pixelweight_attention2 = PixelweightFusion(features, **kw)
        self.up_addconv_block2 = ResBlock(features, features, kernel_size, 1, norm_name, **kw)

    def forward(self, x, skip_conv, skip_vit):
        skip = maybe_remat(self.up_addconv_block1,
                           self.pixelweight_attention1(skip_conv, skip_vit))
        out = self.pixelweight_attention2(self.transp_conv(x), skip)
        return maybe_remat(self.up_addconv_block2, out)


class CatConvBlock(nn.Module):
    """concat(x, skip) -> ResBlock (reference hybrid_CTUNet.py:593-620)."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 norm_name: str = "instance", dtype=torch.float32, device=None):
        super().__init__()
        self.conv_block = ResBlock(cin, features, kernel_size, 1, norm_name, dtype=dtype,
                                   device=device)

    def forward(self, x, skip):
        return maybe_remat(self.conv_block, x, skip)


class UnetOutHead(nn.Module):
    """1x1x1 conv head with bias (MONAI UnetOutBlock; key ``conv.conv``)."""

    def __init__(self, cin: int, features: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv3d(cin, features, 1, 1, bias=True, dtype=dtype, device=device)

    def forward(self, x):
        return self.conv(x)
