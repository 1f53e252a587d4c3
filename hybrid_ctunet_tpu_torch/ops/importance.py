"""Gaussian importance map for sliding-window blending — a numpy copy of
``hybrid_ctunet_tpu/ops/importance.py`` (importing that package's ``ops``
pulls in jax).

MONAI 0.7 ``compute_importance_map(mode='gaussian', sigma_scale=0.125)``:
the outer product of 1D truncated erf-gaussians (sigma = 0.125 * size,
truncated at 4 sigma), normalized by its max, zeros clamped to the smallest
non-zero value.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Sequence, Tuple

import numpy as np


def _erf_gaussian_1d(sigma: float, truncated: float = 4.0) -> np.ndarray:
    tail = int(max(sigma * truncated + 0.5, 1.0))
    x = np.arange(-tail, tail + 1, dtype=np.float64)
    t = 0.70710678 / abs(sigma)
    out = 0.5 * (np.vectorize(math.erf)(t * (x + 0.5)) - np.vectorize(math.erf)(t * (x - 0.5)))
    return np.clip(out, 0.0, None)


def _axis_profile(size: int, sigma_scale: float) -> np.ndarray:
    kernel = _erf_gaussian_1d(sigma_scale * size)
    tail = (len(kernel) - 1) // 2
    center = size // 2
    prof = np.zeros((size,), dtype=np.float64)
    for i in range(size):
        off = i - center
        if -tail <= off <= tail:
            prof[i] = kernel[off + tail]
    return prof


@lru_cache(maxsize=32)
def _gaussian_importance_map_cached(
    patch_size: Tuple[int, ...], sigma_scale: Tuple[float, ...]
) -> np.ndarray:
    profs = [_axis_profile(s, sc) for s, sc in zip(patch_size, sigma_scale)]
    m = profs[0]
    for p in profs[1:]:
        m = np.multiply.outer(m, p)
    m = m / m.max()
    m = m.astype(np.float32)
    nz = m[m != 0]
    if nz.size:
        m = np.clip(m, nz.min(), None)
    m.setflags(write=False)  # cached: every caller shares this array
    return m


def gaussian_importance_map(
    patch_size: Sequence[int], sigma_scale: float | Sequence[float] = 0.125
) -> np.ndarray:
    """Importance map of shape ``patch_size`` (float32, read-only numpy)."""
    ps = tuple(int(s) for s in patch_size)
    if isinstance(sigma_scale, (int, float)):
        sc = tuple(float(sigma_scale) for _ in ps)
    else:
        sc = tuple(float(s) for s in sigma_scale)
    return _gaussian_importance_map_cached(ps, sc)
