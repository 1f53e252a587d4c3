"""Nearest-neighbour volume resampling on the device, scipy-exact. Port of
``hybrid_ctunet_tpu/ops/resize.py``.

The reference downscales the deep-supervision targets on the host every
training step (``ndimage.zoom(target, (1, 1, .5, .5, 1), order=0,
prefilter=False)``, trainer_CTUNet.py:93-94). Here it is an index gather on
the tensor's device, reproducing ``scipy.ndimage.zoom`` (grid_mode=False):
out size ``round(in * zoom)``, out index i -> input coordinate
``i * (in - 1) / (out - 1)``, order 0 -> ``floor(coord + 0.5)``.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch


def _zoom_out_size(in_size: int, zoom: float) -> int:
    return int(round(in_size * zoom))


def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    if out_size <= 1:
        return np.zeros((max(out_size, 1),), dtype=np.int64)
    coords = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    idx = np.floor(coords + 0.5).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


@functools.lru_cache(maxsize=None)
def _device_indices(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    """The indices on ``device``, copied there once: a copy from the host
    waits for the device's queue, mid train step."""
    with torch.inference_mode(False):
        return torch.from_numpy(_nearest_indices(in_size, out_size)).to(device)


def zoom_nearest(x: torch.Tensor, zoom: Sequence[float]) -> torch.Tensor:
    """``scipy.ndimage.zoom(x, zoom, order=0, prefilter=False)``; ``zoom`` has
    one entry per axis of ``x`` (1.0 keeps an axis)."""
    if len(zoom) != x.ndim:
        raise ValueError(f"zoom {zoom} must cover all {x.ndim} axes")
    for axis, z in enumerate(zoom):
        in_size = x.shape[axis]
        out_size = _zoom_out_size(in_size, float(z))
        if out_size == in_size and float(z) == 1.0:
            continue
        x = torch.index_select(x, axis, _device_indices(in_size, out_size, x.device))
    return x


def resample_3d_nearest(x: torch.Tensor, target_size: Sequence[int]) -> torch.Tensor:
    """A 3D volume resampled to ``target_size`` by nearest lookup (reference
    trainer_CTUNet.py:43-48 ``resample_3d``)."""
    if x.ndim != 3:
        raise ValueError(f"expected a 3D volume, got {tuple(x.shape)}")
    for axis, out_size in enumerate(target_size):
        x = torch.index_select(x, axis, _device_indices(x.shape[axis], int(out_size), x.device))
    return x


def downscale_labels(labels: torch.Tensor, spatial_zoom: Tuple[float, float, float]) -> torch.Tensor:
    """Deep-supervision target of channels-last (B, X, Y, Z[, 1]) labels: the
    reference's zoom with factors (1, 1, zx, zy, zz) in NCDHW."""
    if labels.ndim == 5:
        zoom = (1.0, *spatial_zoom, 1.0)
    elif labels.ndim == 4:
        zoom = (1.0, *spatial_zoom)
    else:
        raise ValueError(f"labels must be (B,X,Y,Z[,1]); got {tuple(labels.shape)}")
    return zoom_nearest(labels, zoom)
