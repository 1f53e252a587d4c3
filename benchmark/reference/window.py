"""Plain sliding-window inference with gaussian blending, and the
Hybrid-CTUNet ensemble: the benchmark's frozen copy of the reference's
semantics (MONAI 0.7 ``sliding_window_inference`` with ``mode="gaussian"``,
``sigma_scale=0.125``; test_CTUNet_final.py's softmax mean and argmax).

Window starts: ``dense_patch_slices`` (interval ``int(roi * (1 - overlap))``,
the last start clamped so the window fits); the volume is padded to the ROI
where smaller; each window's prediction is weighted by the importance map
and summed, and the sum divided by the summed weights.
"""
from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch


def window_starts(image: Sequence[int], roi: Sequence[int], overlap: float) -> np.ndarray:
    """(N, 3) window starts, C-order over the axes."""
    axes = []
    for size, r in zip(image, roi):
        step = int(r) if r == size else max(int(r * (1 - overlap)), 1)
        n = max(1, next((d for d in range(math.ceil(size / step)) if d * step + r >= size), 0) + 1)
        axes.append([min(d * step, size - r) for d in range(n)])
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack([m.reshape(-1) for m in mesh], -1)


def importance_map(roi: Sequence[int], sigma_scale: float = 0.125) -> np.ndarray:
    """MONAI's gaussian importance: per axis a truncated (4 sigma) erf
    gaussian of sigma ``sigma_scale * roi`` centred at ``roi // 2``; the
    outer product normalized by its max, zeros raised to the smallest
    non-zero value."""
    profiles = []
    for size in roi:
        sigma = sigma_scale * size
        tail = int(max(sigma * 4.0 + 0.5, 1.0))
        t = 0.70710678 / sigma
        off = np.arange(size) - size // 2
        prof = np.array([0.5 * (math.erf(t * (o + 0.5)) - math.erf(t * (o - 0.5)))
                         if -tail <= o <= tail else 0.0 for o in off])
        profiles.append(np.clip(prof, 0.0, None))
    m = np.multiply.outer(np.multiply.outer(profiles[0], profiles[1]), profiles[2])
    m = (m / m.max()).astype(np.float32)
    return np.clip(m, m[m > 0].min(), None)


@torch.no_grad()
def blend(predict: Callable, volume: torch.Tensor, roi: Sequence[int], overlap: float,
          chunk: int) -> torch.Tensor:
    """(1, X, Y, Z, C_out) float32 blended map of ``volume`` (1, X, Y, Z, C);
    windows through ``predict`` ``chunk`` at a time."""
    image = tuple(volume.shape[1:4])
    lo = [max(r - s, 0) // 2 for r, s in zip(roi, image)]
    hi = [max(r - s, 0) - l for r, s, l in zip(roi, image, lo)]
    pad = [p for l, h in zip(reversed(lo), reversed(hi)) for p in (l, h)]
    padded = torch.nn.functional.pad(volume.float(), [0, 0, *pad])
    size = tuple(padded.shape[1:4])
    starts = window_starts(size, roi, overlap)
    imp = torch.from_numpy(importance_map(roi)).to(volume.device)
    acc = count = None
    rx, ry, rz = roi
    for c0 in range(0, len(starts), chunk):
        s = starts[c0:c0 + chunk].tolist()
        wins = torch.stack([padded[0, x:x + rx, y:y + ry, z:z + rz] for x, y, z in s])
        pred = predict(wins).float()
        if acc is None:
            acc = torch.zeros((*size, pred.shape[-1]), device=volume.device)
            count = torch.zeros(size, device=volume.device)
        for (x, y, z), p in zip(s, pred):
            acc[x:x + rx, y:y + ry, z:z + rz] += imp[..., None] * p
            count[x:x + rx, y:y + ry, z:z + rz] += imp
    out = acc / count[..., None]
    return out[lo[0]:lo[0] + image[0], lo[1]:lo[1] + image[1], lo[2]:lo[2] + image[2]][None]


def ensemble(maps: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean of the maps' float32 softmaxes, and its argmax."""
    prob = sum(torch.softmax(m.float(), -1) for m in maps) / len(maps)
    return prob, prob.argmax(-1)
