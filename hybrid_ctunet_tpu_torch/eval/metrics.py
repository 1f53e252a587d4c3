"""Segmentation metrics: binary Dice and 95th-percentile Hausdorff distance.

Behavior contracts:
- ``dice_score`` — reference utils/utils.py:16-22: binary dice
  ``2|x∩y| / (|x|+|y|)`` over boolean masks, 0.0 when the ground truth is
  empty.
- ``hd95``       — reference test_CTUNet_final.py:99-104: medpy
  ``metric.binary.hd95`` when both masks are non-empty, else 0. Our
  implementation reproduces medpy's algorithm (surface extraction via
  connectivity-1 binary erosion, euclidean distance transform, 95th
  percentile of the stacked symmetric surface distances) with
  scipy.ndimage only.
- ``com_dice``/``com_hd`` — per-case x per-organ (classes 1..13) matrices and
  their means (test_CTUNet_final.py:106-130).

The port's own copy of ``hybrid_ctunet_tpu/eval/metrics.py`` (numpy only; the port
imports nothing of the JAX package).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import ndimage

BTCV_ORGANS = (
    "spleen",
    "right_kidney",
    "left_kidney",
    "gallbladder",
    "esophagus",
    "liver",
    "stomach",
    "aorta",
    "inferior_vena_cava",
    "portal_vein_splenic_vein",
    "pancreas",
    "right_adrenal_gland",
    "left_adrenal_gland",
)
N_CLASSES = 14  # 13 organs + background


def process_label(label: np.ndarray):
    """Split a label volume into the 13 per-organ boolean masks
    (reference test_CTUNet_final.py:83-97)."""
    return tuple(label == c for c in range(1, N_CLASSES))


def dice_score(x: np.ndarray, y: np.ndarray) -> float:
    """Binary dice with the reference's empty-mask rule (utils/utils.py:16-22):
    an empty ground truth ``y`` gives 0.0, whatever ``x`` is."""
    x = np.asarray(x).astype(bool)
    y = np.asarray(y).astype(bool)
    y_sum = y.sum()
    if y_sum == 0:
        return 0.0
    intersect = np.logical_and(x, y).sum()
    return float(2.0 * intersect / (x.sum() + y_sum))


def _surface(mask: np.ndarray) -> np.ndarray:
    """Border voxels (medpy __surface_distances: mask minus its
    connectivity-1 erosion)."""
    conn = ndimage.generate_binary_structure(mask.ndim, 1)
    eroded = ndimage.binary_erosion(mask, structure=conn, iterations=1)
    return mask & ~eroded


def _surface_distances(result: np.ndarray, reference: np.ndarray, voxelspacing=None):
    result = np.atleast_1d(np.asarray(result).astype(bool))
    reference = np.atleast_1d(np.asarray(reference).astype(bool))
    if result.sum() == 0 or reference.sum() == 0:
        raise RuntimeError("surface distance undefined for empty masks")
    result_border = _surface(result)
    reference_border = _surface(reference)
    dt = ndimage.distance_transform_edt(~reference_border, sampling=voxelspacing)
    return dt[result_border]


def hd95(pred: np.ndarray, gt: np.ndarray, voxelspacing=None) -> float:
    """95th-percentile symmetric Hausdorff distance; 0 when either mask is
    empty (the reference's ``hd`` guard, test_CTUNet_final.py:99-104)."""
    pred = np.asarray(pred).astype(bool)
    gt = np.asarray(gt).astype(bool)
    if pred.sum() == 0 or gt.sum() == 0:
        return 0.0
    d1 = _surface_distances(pred, gt, voxelspacing)
    d2 = _surface_distances(gt, pred, voxelspacing)
    return float(np.percentile(np.hstack((d1, d2)), 95))


def per_organ_dice(pred: np.ndarray, label: np.ndarray, n_classes: int = N_CLASSES):
    """Dice for classes 1..n_classes-1 of one case (argmax masks)."""
    return np.array([dice_score(pred == c, label == c) for c in range(1, n_classes)])


def per_organ_hd95(pred: np.ndarray, label: np.ndarray, n_classes: int = N_CLASSES):
    return np.array([hd95(pred == c, label == c) for c in range(1, n_classes)])


def com_dice(infers: Sequence[np.ndarray], labels: Sequence[np.ndarray], *, verbose=True):
    """Mean per-organ dice over a case list (test_CTUNet_final.py:106-117)."""
    rows = [per_organ_dice(p, l) for p, l in zip(infers, labels)]
    mean_dice = np.mean(rows, 0)
    if verbose:
        print(f"Overall Mean Organ Dice: {np.round(mean_dice, 4)}")
        print(f"Overall Mean Dice: {np.mean(mean_dice)}")
    return mean_dice


def com_hd(infers: Sequence[np.ndarray], labels: Sequence[np.ndarray], *, verbose=True):
    """Mean per-organ HD95 over a case list (test_CTUNet_final.py:119-130)."""
    rows = [per_organ_hd95(p, l) for p, l in zip(infers, labels)]
    mean_hd = np.mean(rows, 0)
    if verbose:
        print(f"Overall Mean Organ HD: {np.round(mean_hd, 4)}")
        print(f"Overall Mean HD: {np.mean(mean_hd)}")
    return mean_hd
