"""3D ViT encoder. Port of ``hybrid_ctunet_tpu/models/vit3d.py`` (reference
networks/vit.py): patch grid (X/16, Y/16, Z/pf) with token order (h w f) and
patch features (p1 p2 pf c); LN -> Linear -> LN embedding; learned position
embedding (1, N, dim); no CLS token; pre-norm blocks x = attn(x) + x,
x = ff(x) + x. Attention and FFN are plain PyTorch here, as in the JAX
package, where no Pallas kernel computes them. Dropout (JAX
``models/vit3d.py:46-65,82,187-188``): on the softmaxed scores, after
``to_out``, in the FFN and after the position embedding; train mode only.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .layers import Dense, Dropout, FeedForward, LayerNorm, _empty, maybe_remat


class ViTAttention(nn.Module):
    """Pre-norm MHSA: qkv bias-free, out projection with bias (skipped when
    heads == 1 and dim_head == dim, as in the reference). Scores summed in
    fp32, fp32 softmax, probabilities in the compute dtype."""

    def __init__(self, dim: int, heads: int = 12, dim_head: int = 64, dropout: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        inner = heads * dim_head
        self.norm = LayerNorm(dim, device=device)
        self.to_qkv = Dense(dim, 3 * inner, bias=False, dtype=dtype, device=device)
        self.drop_attn = Dropout(dropout)
        self.project_out = not (heads == 1 and dim_head == dim)
        if self.project_out:
            self.to_out = nn.Sequential(Dense(inner, dim, dtype=dtype, device=device),
                                        Dropout(dropout))

    def forward(self, x):
        B, N, _ = x.shape
        inner = self.heads * self.dim_head
        qkv = self.to_qkv(self.norm(x))

        def split(t):
            return t.reshape(B, N, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = (split(t) for t in qkv.split(inner, dim=-1))
        q = q * self.dim_head ** -0.5
        sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
        attn = self.drop_attn(torch.softmax(sim, dim=-1).to(self.dtype))
        out = torch.matmul(attn.float(), v.float()).to(self.dtype)
        out = out.transpose(1, 2).reshape(B, N, inner)
        return self.to_out(out) if self.project_out else out


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int, dropout: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.attn = ViTAttention(dim, heads, dim_head, dropout, dtype=dtype, device=device)
        self.ff = FeedForward(dim, mlp_dim, residual=True, dropout=dropout, dtype=dtype,
                              device=device)

    def forward(self, x):
        x = self.attn(x) + x
        return self.ff(x)


class ViT3D(nn.Module):
    """Volumetric ViT over channels-last input (B, X, Y, Z, C). Keys follow
    the reference: ``to_patch_embedding.{1,2,3}``, ``pos_embedding``,
    ``transformer.{i}.attn/ff``."""

    def __init__(self, image_size: Tuple[int, int] = (96, 96), frames: int = 96,
                 image_patch_size: int = 16, frame_patch_size: int = 8,
                 in_channels: int = 1, dim: int = 768, depth: int = 12, heads: int = 12,
                 dim_head: int = 64, mlp_dim: int = 3072, dropout: float = 0.0,
                 dtype=torch.float32, device=None):
        super().__init__()
        p, pf = image_patch_size, frame_patch_size
        if image_size[0] % p or image_size[1] % p or frames % pf:
            raise ValueError(
                f"volume {(*image_size, frames)} not divisible by patch size {(p, p, pf)}"
            )
        self.patch = (p, p, pf)
        self.grid = (image_size[0] // p, image_size[1] // p, frames // pf)
        self.dim, self.dtype = dim, dtype
        patch_dim = in_channels * p * p * pf
        n_tokens = self.grid[0] * self.grid[1] * self.grid[2]
        # index 0 is the reference's Rearrange (done in forward)
        self.to_patch_embedding = nn.Sequential(
            nn.Identity(),
            LayerNorm(patch_dim, device=device),
            Dense(patch_dim, dim, dtype=dtype, device=device),
            LayerNorm(dim, device=device),
        )
        self.pos_embedding = _empty(1, n_tokens, dim, device=device)
        self.emb_dropout = Dropout(dropout)
        self.transformer = nn.ModuleList(
            TransformerBlock(dim, heads, dim_head, mlp_dim, dropout, dtype=dtype, device=device)
            for _ in range(depth)
        )

    def forward(self, x):
        B, X, Y, Z, C = x.shape
        p1, p2, pf = self.patch
        if X % p1 or Y % p2 or Z % pf:
            raise ValueError(f"volume {(X, Y, Z)} not divisible by patch size {self.patch}")
        gh, gw, gf = X // p1, Y // p2, Z // pf
        # (h p1)(w p2)(f pf) c -> tokens (h w f) x features (p1 p2 pf c)
        t = x.reshape(B, gh, p1, gw, p2, gf, pf, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
        t = t.reshape(B, gh * gw * gf, p1 * p2 * pf * C).to(self.dtype)
        t = self.to_patch_embedding(t)
        t = self.emb_dropout(t + self.pos_embedding.to(self.dtype))
        for block in self.transformer:
            t = maybe_remat(block, t)
        return t  # (B, N, dim), token order (h w f)
