"""Seeded weights for a configuration's models, made on the device in one
draw and shared by the program and the reference as one state dict.

The draw is a single standard-normal tensor from a ``torch.Generator``
seeded with the run's seed; each parameter is a slice of it, shifted and
scaled in place:

- conv and transposed-conv weights: N(mu, 2 / fan_in) with
  mu = sqrt(2 / fan_in) / sqrt(fan_in) (fan_in = Cin k^3 for the scale; Cin k^3
  for a conv's shift and Cin for a transposed conv's, the inputs one output
  voxel sums). The small positive mean puts the random ResNet with
  InstanceNorm and LeakyReLU at the edge between order and chaos: with
  zero-mean filters a perturbation of the input grows about 3000-fold through
  the 101 layers, so bfloat16 rounding alone decorrelates the res head from
  float32; with this mean it passes through the encoder at about its own
  size (PERF.md, "Cells");
- linear weights N(0, 1 / fan_in);
- position embeddings and relative-position tables N(0, 1);
- LayerNorm scales 1 + N(0, 0.01), every bias N(0, 0.01), so that a
  dropped scale or bias shows.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch


def make(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int, device,
         offset: int = 0) -> Dict[str, torch.Tensor]:
    """float32 parameters of ``shapes`` ((name, shape) in the model's order)
    from ``seed``; ``offset`` skips that many draws, so that two models of
    one configuration take disjoint parts of one stream."""
    total = sum(math.prod(s) for _, s in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(offset + total, generator=gen, device=device)[offset:]
    out, pos = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        p = flat[pos:pos + n].view(shape)
        pos += n
        _shape_leaf(name, p)
        out[name] = p
    return out


@torch.no_grad()
def _shape_leaf(name: str, p: torch.Tensor) -> None:
    """Turn a standard-normal slice into the leaf's distribution, in place."""
    if name.endswith("pos_embedding") or name.endswith("rel_pos_bias.weight"):
        return
    if p.ndim == 1:
        p.mul_(0.1)
        if not name.endswith(".bias"):  # a LayerNorm scale
            p.add_(1.0)
    elif p.ndim == 2:
        p.mul_(math.sqrt(1.0 / p.shape[1]))
    elif p.ndim == 5:
        taps = math.prod(p.shape[2:])
        if name.endswith("transp_conv.conv.weight"):  # (Cin, Cout, k, k, k)
            fan, shift_fan = p.shape[0] * taps, p.shape[0]
        else:  # (Cout, Cin, k, k, k)
            fan = shift_fan = p.shape[1] * taps
        p.add_(shift_fan ** -0.5).mul_(math.sqrt(2.0 / fan))
    else:
        raise ValueError(f"no rule for {name} {tuple(p.shape)}")
