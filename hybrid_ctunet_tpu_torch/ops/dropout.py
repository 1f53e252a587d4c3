"""Dropout with an explicit generator. The JAX package draws its masks from
the ``dropout`` rng collection (flax ``nn.Dropout``); here each draw comes
from a ``torch.Generator`` that the caller owns and seeds, never from the
global RNG. Keep probability 1 - rate, kept values scaled by 1 / (1 - rate)
in the input's dtype; rate 1 gives zeros, as flax and ``F.dropout`` do."""
from __future__ import annotations

import torch


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), x.new_zeros(()))
