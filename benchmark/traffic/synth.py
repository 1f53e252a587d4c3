"""Synthetic abdominal CT cases, the benchmark's own generator: the one code
that every traffic file's cases come from.

A case is a volume in whole Hounsfield units (as a CT scan stores them) on
the target grid with a label of
``classes`` classes: a body of soft tissue (N(40, 30) HU) that fills the
volume in-plane as a cylinder along z, air (N(-400, 150) HU) in the corners
outside it, and ``classes - 1`` ellipsoid organs (N(80 + 10 k, 10) HU) with
centres in the middle half of the volume and radii 5-18% of it. After the
intensity window and the crop to the foreground (the reference's
preprocessing) a case keeps its full size, as a BTCV case after
preprocessing does. Everything is drawn from one ``torch.Generator`` seeded
by the run's seed and the case's index, on the device it is asked for.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def case(shape: Sequence[int], classes: int, seed: int, index: int,
         device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(HU volume (X, Y, Z) float32, label (X, Y, Z) uint8) on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(index)) % (2 ** 63))
    axes = [torch.linspace(-1.0, 1.0, int(n), device=device) for n in shape]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    img = torch.randn(tuple(shape), generator=gen, device=device) * 150.0 - 400.0
    label = torch.zeros(tuple(shape), dtype=torch.uint8, device=device)
    body = gx ** 2 + gy ** 2 <= 1.0
    tissue = torch.randn(tuple(shape), generator=gen, device=device) * 30.0 + 40.0
    img = torch.where(body, tissue, img)
    centres = torch.rand((classes, 3), generator=gen, device=device) - 0.5
    radii = torch.rand((classes, 3), generator=gen, device=device) * 0.13 + 0.05
    noise = torch.randn(tuple(shape), generator=gen, device=device) * 10.0
    for k in range(1, classes):
        c, r = centres[k], radii[k]
        inside = (((gx - c[0]) / r[0]) ** 2 + ((gy - c[1]) / r[1]) ** 2
                  + ((gz - c[2]) / r[2]) ** 2 < 1.0) & body
        img = torch.where(inside, noise + (80.0 + 10.0 * k), img)
        label = torch.where(inside, torch.full_like(label, k), label)
    return torch.round(img), label


def window(hu: torch.Tensor, a_min: float, a_max: float, b_min: float, b_max: float):
    """The reference's intensity window, clipped: HU to [b_min, b_max]."""
    out = (hu.float() - a_min) / (a_max - a_min)
    return torch.clamp(out * (b_max - b_min) + b_min, b_min, b_max)
