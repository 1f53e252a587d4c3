"""The train crops as the reference's data pipeline makes them
(utils/data_utils.py: ScaleIntensityRanged, CropForegroundd,
RandCropByPosNegLabeld with ``num_samples`` 4, RandFlipd on each axis,
RandRotate90d, RandScaleIntensityd, RandShiftIntensityd), written again for
the benchmark in numpy.

The draws follow the loader's protocol: an epoch's case order is
``default_rng((seed, epoch)).permutation(n)``, and the crops and
augmentations of the case at position ``b`` come from
``default_rng((seed, epoch, case, b))`` in the order the transforms run.
Cases are on the target grid already (1.5 x 1.5 x 2.0 mm, RAS), so the
orientation and spacing steps are the identity and are not written here;
:func:`preprocess` refuses a case that is not on that grid.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def preprocess(image: np.ndarray, label: np.ndarray, affine: np.ndarray, pixdim: Sequence[float],
               a_min: float, a_max: float, b_min: float, b_max: float):
    """Intensity window to [b_min, b_max] (clipped), then the crop to the
    bounding box of the voxels above 0."""
    if not np.allclose(affine, np.diag([*pixdim, 1.0])):
        raise ValueError(f"case not on the target grid {pixdim}: affine {affine.tolist()}")
    img = (image.astype(np.float32) - a_min) / (a_max - a_min)
    img = np.clip(img * (b_max - b_min) + b_min, b_min, b_max)
    nz = np.nonzero(img > 0)
    lo = [int(c.min()) for c in nz]
    hi = [int(c.max()) + 1 for c in nz]
    sl = tuple(slice(a, b) for a, b in zip(lo, hi))
    return img[sl][..., None], label[sl][..., None]


def crops(img: np.ndarray, label: np.ndarray, rng: np.random.Generator, roi: Sequence[int],
          num_samples: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """RandCropByPosNegLabel (pos 1, neg 1, image threshold 0): each centre
    drawn from the foreground voxels or, with the same chance, from the
    background voxels whose image is above 0; the window clamped into the
    volume."""
    size = np.asarray(roi)
    shape = np.asarray(img.shape[:3])
    if (shape < size).any():
        raise ValueError(f"case {tuple(shape)} smaller than the crop {tuple(size)}")
    lab, im = label[..., 0], img[..., 0]
    fg = np.stack(np.nonzero(lab > 0), -1)
    bg = np.stack(np.nonzero((lab <= 0) & (im > 0)), -1)
    if len(fg) == 0:
        fg = bg
    if len(bg) == 0:
        bg = fg
    out = []
    for _ in range(num_samples):
        pool = fg if rng.random() < 0.5 else bg
        centre = pool[rng.integers(0, len(pool))]
        start = np.clip(centre - size // 2, 0, shape - size)
        sl = tuple(slice(int(s), int(s + z)) for s, z in zip(start, size))
        out.append((img[sl], label[sl]))
    return out


def augment(img, label, rng, probs: Dict[str, float]):
    """Flips on axes 0, 1, 2; a rotation by k x 90 degrees (k in 1..3) in
    the (0, 1) plane; intensity scaled by 1 + U(-0.1, 0.1); shifted by
    U(-0.1, 0.1); each with its probability."""
    for axis in (0, 1, 2):
        if rng.random() < probs["RandFlipd_prob"]:
            img, label = np.flip(img, axis), np.flip(label, axis)
    if rng.random() < probs["RandRotate90d_prob"]:
        k = int(rng.integers(1, 4))
        img, label = np.rot90(img, k, (0, 1)), np.rot90(label, k, (0, 1))
    if rng.random() < probs["RandScaleIntensityd_prob"]:
        img = img * (1.0 + rng.uniform(-0.1, 0.1))
    if rng.random() < probs["RandShiftIntensityd_prob"]:
        img = img + rng.uniform(-0.1, 0.1)
    return np.ascontiguousarray(img, np.float32), np.ascontiguousarray(label)


def batches(cases: List[Tuple[np.ndarray, np.ndarray]], seed: int, steps: int, roi, num_samples,
            probs):
    """The first ``steps`` batches (one case each, ``num_samples`` crops):
    (image (S, X, Y, Z, 1) float32, label (S, X, Y, Z, 1))."""
    out, epoch = [], 0
    while len(out) < steps:
        order = np.random.default_rng((seed, epoch)).permutation(len(cases))
        for b, case in enumerate(order.tolist()):
            if len(out) == steps:
                break
            rng = np.random.default_rng((seed, epoch, case, b))
            img, lab = cases[case]
            pairs = [augment(ci, cl, rng, probs)
                     for ci, cl in crops(img, lab, rng, roi, num_samples)]
            out.append((np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])))
        epoch += 1
    return out
