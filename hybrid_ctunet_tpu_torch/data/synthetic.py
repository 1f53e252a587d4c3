"""Synthetic BTCV-like volumes for tests and benchmarks (the repository ships
no data; the reference assumes a local BTCV download, README.md:56-87).

The port's own copy of ``hybrid_ctunet_tpu/data/synthetic.py`` (numpy only; the port
imports nothing of the JAX package).
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from .nifti import save_nifti


def make_volume(
    rng: np.random.Generator,
    shape: Tuple[int, int, int] = (128, 128, 64),
    n_classes: int = 14,
) -> Tuple[np.ndarray, np.ndarray]:
    """A CT-like volume in HU with blob organs: image (X,Y,Z) float32 HU,
    label (X,Y,Z) uint8."""
    img = rng.normal(-400.0, 150.0, shape).astype(np.float32)  # airy background
    lab = np.zeros(shape, np.uint8)
    # body ellipsoid of soft tissue
    grid = np.stack(np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij"))
    body = (grid[0] ** 2 + grid[1] ** 2 + 0.5 * grid[2] ** 2) < 0.8
    img[body] = rng.normal(40.0, 30.0, body.sum()).astype(np.float32)
    for organ in range(1, n_classes):
        centre = rng.uniform(-0.5, 0.5, 3)
        radii = rng.uniform(0.05, 0.18, 3)
        d = sum(((grid[i] - centre[i]) / radii[i]) ** 2 for i in range(3))
        mask = (d < 1.0) & body
        img[mask] = rng.normal(80.0 + 10 * organ, 10.0, mask.sum()).astype(np.float32)
        lab[mask] = organ
    return img, lab


def write_synthetic_dataset(
    root: str,
    *,
    n_train: int = 2,
    n_val: int = 1,
    shape: Tuple[int, int, int] = (128, 128, 64),
    spacing: Tuple[float, float, float] = (1.0, 1.0, 2.5),
    seed: int = 0,
    n_classes: int = 14,
) -> str:
    """Write a decathlon-layout synthetic dataset; returns the datalist path.
    Labels lie in [0, n_classes) (the JAX package's writer always uses 14)."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "imagesTr"), exist_ok=True)
    os.makedirs(os.path.join(root, "labelsTr"), exist_ok=True)
    affine = np.diag([*spacing, 1.0])

    def _write(split, i):
        img, lab = make_volume(rng, shape, n_classes)
        ip = os.path.join("imagesTr", f"{split}_{i:03d}.nii.gz")
        lp = os.path.join("labelsTr", f"{split}_{i:03d}.nii.gz")
        save_nifti(os.path.join(root, ip), img, affine)
        save_nifti(os.path.join(root, lp), lab, affine)
        return {"image": ip, "label": lp}

    spec = {
        "training": [_write("tr", i) for i in range(n_train)],
        "validation": [_write("val", i) for i in range(n_val)],
    }
    path = os.path.join(root, "dataset_synth.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return path
