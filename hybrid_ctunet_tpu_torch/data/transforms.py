"""Volumetric preprocessing pipeline with invertibility metadata.

Capability match for the reference's MONAI transform chains
(utils/data_utils.py:69-143):

  train:   Load -> AddChannel -> Orientation(RAS) -> Spacing(1.5,1.5,2.0;
           bilinear/nearest) -> ScaleIntensityRange(-175..250 -> 0..1, clip)
           -> CropForeground -> RandCropByPosNegLabel(96^3, pos=1, neg=1, x4)
           -> RandFlip x3(p=.2) -> RandRotate90(p=.2)
           -> RandScaleIntensity(.1, p=.1) -> RandShiftIntensity(.1, p=.1)
  val/test ("invert_transform"): same deterministic chain but *labels stay on
           the native grid*; predictions are inverted back (MONAI Invertd,
           trainer_CTUNet.py:141-178) — here via the recorded metadata.

All transforms are channels-last numpy (host-side), matching where the
reference runs them (CPU dataloader workers); the random ops take an explicit
``np.random.Generator`` so distributed parity is controlled by seeding.

The port's own copy of ``hybrid_ctunet_tpu/data/transforms.py`` (numpy only; the port
imports nothing of the JAX package).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.ndimage as ndimage


# ---------------------------------------------------------------- orientation

def _io_orientation(affine: np.ndarray) -> np.ndarray:
    """(axis, flip) pairs mapping array axes to nearest RAS axes.

    Transcribes nibabel's ``io_orientation`` algorithm (the oracle behind
    MONAI 0.7 Orientationd, which the reference uses at
    utils/data_utils.py:75): normalize the affine's rotation/zoom block by
    column norms, take the *polar decomposition* via SVD to get the closest
    orthogonal matrix (this is what makes oblique/shear affines tie-break the
    same way nibabel does — a plain column argmax does not), then assign each
    input axis in order to the strongest remaining output axis, zeroing the
    claimed row."""
    rzs = affine[:3, :3].astype(np.float64)
    zooms = np.sqrt((rzs ** 2).sum(axis=0))
    zooms[zooms == 0] = 1.0
    rs = rzs / zooms
    P, S, Qs = np.linalg.svd(rs, full_matrices=False)
    tol = S.max() * max(rs.shape) * np.finfo(S.dtype).eps
    keep = S > tol
    R = P[:, keep] @ Qs[keep]
    ornt = np.full((3, 2), np.nan)
    for in_ax in range(3):
        col = R[:, in_ax]
        if not np.allclose(col, 0):
            out_ax = int(np.argmax(np.abs(col)))
            ornt[in_ax, 0] = out_ax
            ornt[in_ax, 1] = -1.0 if col[out_ax] < 0 else 1.0
            R[out_ax, :] = 0  # claimed: drop from consideration
    if np.isnan(ornt).any():
        raise ValueError(f"degenerate affine, cannot orient: {affine}")
    return ornt


def orientation_ras(
    data: np.ndarray, affine: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Reorient (X,Y,Z,...) array + affine to RAS. Returns data, new affine,
    and metadata sufficient to invert."""
    ornt = _io_orientation(affine)
    perm = np.argsort(ornt[:, 0]).tolist()  # array axis order so axis i -> world i
    flips = [ornt[perm[i], 1] < 0 for i in range(3)]

    out = np.transpose(data, perm + list(range(3, data.ndim)))
    for ax, f in enumerate(flips):
        if f:
            out = np.flip(out, axis=ax)
    out = np.ascontiguousarray(out)

    # updated affine
    shape = data.shape[:3]
    T = np.eye(4)
    rot = np.zeros((3, 3))
    offs = np.zeros(3)
    for new_ax in range(3):
        old_ax = perm[new_ax]
        sgn = -1.0 if flips[new_ax] else 1.0
        rot[old_ax, new_ax] = sgn
        if flips[new_ax]:
            offs[old_ax] = shape[old_ax] - 1
    T[:3, :3] = rot
    T[:3, 3] = offs
    new_affine = affine @ T
    meta = {"perm": perm, "flips": flips, "orig_shape": tuple(shape)}
    return out, new_affine, meta


def invert_orientation(data: np.ndarray, meta: Dict) -> np.ndarray:
    out = data
    for ax, f in enumerate(meta["flips"]):
        if f:
            out = np.flip(out, axis=ax)
    inv_perm = np.argsort(meta["perm"]).tolist()
    return np.ascontiguousarray(np.transpose(out, inv_perm + list(range(3, data.ndim))))


# ------------------------------------------------------------------- spacing
#
# Transcription of MONAI 0.7's Spacing transform (the one the reference's
# Spacingd/Invertd chain runs: utils/data_utils.py:72-143 with the defaults
# padding_mode="border", align_corners=False, diagonal=False, dtype=float64):
#
#   new_affine     = zoom_affine(affine, pixdim, diagonal=False)
#   shape, offset  = compute_shape_offset(spatial_shape, affine, new_affine)
#   new_affine[:3,3] = offset
#   index map      = inv(affine) @ new_affine     (output index -> input index)
#   resample       = grid_sample(..., padding_mode="border")
#
# MONAI's AffineTransform(normalized=False) composes to_norm_affine with
# grid_sample such that the net sampling position for output voxel j is
# exactly (index map) @ j in plain index space; scipy's affine_transform with
# matrix/offset from that map and mode="nearest" (= border clamp for linear
# interpolation) reproduces it without torch.


def zoom_affine(affine: np.ndarray, pixdim: Sequence[float]) -> np.ndarray:
    """MONAI zoom_affine(diagonal=False): keep direction cosines (and axis
    sign), replace the per-axis zooms with ``pixdim``, drop translation and
    shear. R = rzs @ inv(chol(rzs^T rzs)^T) is the rotation factor of the
    RZS polar-like decomposition MONAI uses."""
    scale = np.asarray(pixdim, np.float64).copy()
    scale[scale == 0] = 1.0
    rzs = affine[:3, :3].astype(np.float64)
    zs = np.linalg.cholesky(rzs.T @ rzs).T
    rotation = rzs @ np.linalg.inv(zs)
    s = np.sign(np.diag(zs)) * np.abs(scale)
    new_affine = np.eye(4)
    new_affine[:3, :3] = rotation @ np.diag(s)
    return new_affine


def compute_shape_offset(
    spatial_shape: Sequence[int], in_affine: np.ndarray, out_affine: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """MONAI compute_shape_offset: map the 8 input-corner voxel centres to
    world, then into the output grid; shape = round(ptp + 1) per axis, offset
    = world position of the corner that lands at the minimal output coords
    (corner 0 if none is minimal in every axis simultaneously)."""
    shape = np.asarray(spatial_shape, np.float64)
    in_coords = [(0.0, dim - 1.0) for dim in shape]
    corners = np.asarray(np.meshgrid(*in_coords, indexing="ij")).reshape((3, -1))
    corners = np.concatenate((corners, np.ones_like(corners[:1])))
    corners = in_affine @ corners
    inv_out = np.linalg.inv(out_affine)
    corners_out = inv_out @ corners
    corners_out = corners_out[:-1] / corners_out[-1]
    out_shape = np.round(np.ptp(corners_out, axis=1) + 1.0)
    k = 0
    for i in range(corners.shape[1]):
        min_corner = np.min(inv_out @ corners - (inv_out @ corners)[:, i : i + 1], 1)
        if np.allclose(min_corner, 0.0, atol=1.0e-7):
            k = i
            break
    offset = corners[:3, k]
    return out_shape.astype(int), offset


def _affine_resample(
    data: np.ndarray,
    index_map: np.ndarray,
    out_shape: Tuple[int, ...],
    mode: str,
) -> np.ndarray:
    """Per-channel scipy resample with the homogeneous output->input index
    map. order=1 + mode="nearest" == grid_sample bilinear + border padding;
    compute in float64 like MONAI's dtype=np.float64 default, return float32
    (images) / input dtype (nearest labels, values are exact)."""
    matrix, offset = index_map[:3, :3], index_map[:3, 3]

    if mode != "bilinear":
        # torch grid_sample "nearest" rounds with nearbyint (half-to-even);
        # scipy's order-0 spline rounds half-up, which breaks ties the wrong
        # way on exact .5 coordinates (common for rational spacing ratios
        # like 1.0 -> 1.5). Gather with np.rint + border clip instead.
        xs = [np.arange(n, dtype=np.float64) for n in out_shape]
        jj = np.stack(np.meshgrid(*xs, indexing="ij"), axis=0).reshape(3, -1)
        pp = matrix @ jj + offset[:, None]
        idx = [
            np.clip(np.rint(pp[a]).astype(np.int64), 0, data.shape[a] - 1)
            for a in range(3)
        ]
        out = data[idx[0], idx[1], idx[2]].reshape(
            tuple(out_shape) + data.shape[3:]
        )
        return out.astype(data.dtype)

    def _one(ch):
        return ndimage.affine_transform(
            ch.astype(np.float64),
            matrix,
            offset=offset,
            output_shape=tuple(out_shape),
            order=1,
            mode="nearest",
            prefilter=False,
        )

    if data.ndim == 3:
        out = _one(data)
    else:
        out = np.stack([_one(data[..., c]) for c in range(data.shape[-1])], axis=-1)
    return out.astype(np.float32)


def spacing_resample(
    data: np.ndarray,
    affine: np.ndarray,
    pixdim: Sequence[float],
    *,
    mode: str = "bilinear",
) -> Tuple[np.ndarray, np.ndarray, Dict]:
    """Resample (X,Y,Z[,C]) to target spacing with MONAI-0.7 Spacing
    semantics (shape = round((n-1)*old/new + 1) from corner mapping, border
    padding, oblique direction cosines preserved)."""
    affine = np.asarray(affine, np.float64)
    new_affine = zoom_affine(affine, pixdim)
    out_shape, offset = compute_shape_offset(data.shape[:3], affine, new_affine)
    new_affine[:3, 3] = offset
    index_map = np.linalg.inv(affine) @ new_affine

    meta = {
        "orig_shape": tuple(int(s) for s in data.shape[:3]),
        "orig_affine": affine.tolist(),
        "new_affine": new_affine.tolist(),
        "new_shape": tuple(int(s) for s in out_shape),
    }
    # MONAI's near-identity short-circuit: no resampling at all
    if tuple(out_shape) == data.shape[:3] and np.allclose(
        index_map, np.eye(4), atol=1e-3
    ):
        out = data.astype(data.dtype if mode != "bilinear" else np.float32)
        return out, new_affine, meta
    out = _affine_resample(data, index_map, tuple(out_shape), mode)
    return out, new_affine, meta


def invert_spacing(data: np.ndarray, meta: Dict, *, mode: str = "bilinear") -> np.ndarray:
    """Map a (X,Y,Z[,C]) volume on the resampled grid back to the native grid
    the way MONAI Invertd does (trainer_CTUNet.py:141-178, nearest_interp=
    False -> linear for logits): run Spacing AGAIN targeting the original
    pixdim (column norms of the pre-spacing affine) with the output shape
    forced to the original, not the literal matrix inverse."""
    cur_affine = np.asarray(meta["new_affine"], np.float64)
    orig_affine = np.asarray(meta["orig_affine"], np.float64)
    orig_pixdim = np.sqrt((orig_affine[:3, :3] ** 2).sum(axis=0))

    new_affine = zoom_affine(cur_affine, orig_pixdim)
    _, offset = compute_shape_offset(data.shape[:3], cur_affine, new_affine)
    new_affine[:3, 3] = offset
    index_map = np.linalg.inv(cur_affine) @ new_affine
    if tuple(meta["orig_shape"]) == data.shape[:3] and np.allclose(
        index_map, np.eye(4), atol=1e-3
    ):
        return data.astype(data.dtype if mode != "bilinear" else np.float32)
    return _affine_resample(data, index_map, tuple(meta["orig_shape"]), mode)


# ----------------------------------------------------------------- intensity

def scale_intensity_range(
    img: np.ndarray, a_min: float, a_max: float, b_min: float, b_max: float, clip: bool = True
) -> np.ndarray:
    out = (img.astype(np.float32) - a_min) / (a_max - a_min)
    out = out * (b_max - b_min) + b_min
    if clip:
        out = np.clip(out, b_min, b_max)
    return out


# ---------------------------------------------------------------------- crop

def foreground_bbox(img: np.ndarray, *, margin: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Bounding box of img > 0 (MONAI CropForegroundd default select_fn)."""
    fg = img > 0
    if fg.ndim == 4:
        fg = fg.any(axis=-1)
    coords = np.nonzero(fg)
    if len(coords[0]) == 0:
        return np.zeros(3, int), np.asarray(fg.shape)
    lo = np.array([max(int(c.min()) - margin, 0) for c in coords])
    hi = np.array([min(int(c.max()) + 1 + margin, s) for c, s in zip(coords, fg.shape)])
    return lo, hi


def crop_foreground(
    img: np.ndarray, label: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, Optional[np.ndarray], Dict]:
    lo, hi = foreground_bbox(img)
    sl = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
    meta = {"bbox_lo": lo.tolist(), "bbox_hi": hi.tolist(), "orig_shape": tuple(img.shape[:3])}
    cropped = img[sl]
    clabel = label[sl] if label is not None else None
    return cropped, clabel, meta


def invert_crop(data: np.ndarray, meta: Dict, fill: float = 0.0) -> np.ndarray:
    """Pad a cropped-grid volume back to the pre-crop grid."""
    lo, hi = meta["bbox_lo"], meta["bbox_hi"]
    full_shape = tuple(meta["orig_shape"]) + data.shape[3:]
    out = np.full(full_shape, fill, dtype=data.dtype)
    sl = tuple(slice(a, b) for a, b in zip(lo, hi))
    out[sl] = data
    return out


# --------------------------------------------------------------- random crop

def rand_crop_by_pos_neg_label(
    img: np.ndarray,
    label: np.ndarray,
    rng: np.random.Generator,
    *,
    spatial_size: Tuple[int, int, int] = (96, 96, 96),
    pos: float = 1.0,
    neg: float = 1.0,
    num_samples: int = 4,
    image_threshold: float = 0.0,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """MONAI RandCropByPosNegLabeld semantics (utils/data_utils.py:84-93):
    each sample's centre drawn from foreground (label>0) with prob
    pos/(pos+neg), else from background voxels where image>threshold; windows
    clamped inside the (padded-if-needed) volume."""
    size = np.asarray(spatial_size)
    shape = np.asarray(img.shape[:3])

    # pad symmetrically if smaller than the crop (MONAI pads with zeros)
    if (shape < size).any():
        diff = np.maximum(size - shape, 0)
        lo = diff // 2
        hi = diff - lo
        pad = [(int(l), int(h)) for l, h in zip(lo, hi)] + [(0, 0)] * (img.ndim - 3)
        img = np.pad(img, pad)
        pad_l = [(int(l), int(h)) for l, h in zip(lo, hi)] + [(0, 0)] * (label.ndim - 3)
        label = np.pad(label, pad_l)
        shape = np.asarray(img.shape[:3])

    lab3 = label[..., 0] if label.ndim == 4 else label
    img3 = img[..., 0] if img.ndim == 4 else img
    fg = np.stack(np.nonzero(lab3 > 0), axis=-1)
    bg_mask = (lab3 <= 0) & (img3 > image_threshold)
    bg = np.stack(np.nonzero(bg_mask), axis=-1)
    if len(fg) == 0:
        fg = bg
    if len(bg) == 0:
        bg = fg

    half_lo = size // 2
    p_pos = pos / (pos + neg)
    out = []
    for _ in range(num_samples):
        pool = fg if rng.random() < p_pos else bg
        centre = pool[rng.integers(0, len(pool))]
        start = np.clip(centre - half_lo, 0, shape - size)
        sl = tuple(slice(int(s), int(s + z)) for s, z in zip(start, size))
        out.append((img[sl], label[sl]))
    return out


# ------------------------------------------------------------- augmentations

def rand_flip(img, label, rng, *, prob: float = 0.2, axis: int = 0):
    if rng.random() < prob:
        img = np.flip(img, axis=axis)
        label = np.flip(label, axis=axis)
    return img, label


def rand_rotate90(img, label, rng, *, prob: float = 0.2, max_k: int = 3, axes=(0, 1)):
    if rng.random() < prob:
        k = int(rng.integers(1, max_k + 1))
        img = np.rot90(img, k, axes=axes)
        label = np.rot90(label, k, axes=axes)
    return img, label


def rand_scale_intensity(img, rng, *, factors: float = 0.1, prob: float = 0.1):
    if rng.random() < prob:
        img = img * (1.0 + rng.uniform(-factors, factors))
    return img


def rand_shift_intensity(img, rng, *, offsets: float = 0.1, prob: float = 0.1):
    if rng.random() < prob:
        img = img + rng.uniform(-offsets, offsets)
    return img


def augment_crop(img, label, rng, cfg) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's augmentation tail (data_utils.py:94-99)."""
    for axis in (0, 1, 2):
        img, label = rand_flip(img, label, rng, prob=cfg.get("RandFlipd_prob", 0.2), axis=axis)
    img, label = rand_rotate90(img, label, rng, prob=cfg.get("RandRotate90d_prob", 0.2))
    img = rand_scale_intensity(img, rng, prob=cfg.get("RandScaleIntensityd_prob", 0.1))
    img = rand_shift_intensity(img, rng, prob=cfg.get("RandShiftIntensityd_prob", 0.1))
    return np.ascontiguousarray(img, np.float32), np.ascontiguousarray(label)


# ------------------------------------------------------------- full pipeline

@dataclass
class CaseMeta:
    """Everything needed to invert predictions to the native grid."""

    affine: np.ndarray
    orientation: Dict = field(default_factory=dict)
    spacing: Dict = field(default_factory=dict)
    crop: Dict = field(default_factory=dict)
    resample_labels: bool = True


def preprocess_case(
    image: np.ndarray,
    affine: np.ndarray,
    label: Optional[np.ndarray] = None,
    *,
    pixdim=(1.5, 1.5, 2.0),
    a_min=-175.0,
    a_max=250.0,
    b_min=0.0,
    b_max=1.0,
    resample_labels: bool = True,
):
    """Deterministic chain: orient RAS -> spacing -> intensity -> crop-fg.

    ``resample_labels=False`` reproduces the reference's val/test
    "invert_transform" where labels stay native (data_utils.py:103-115).
    Returns (image[X,Y,Z,1], label|None, CaseMeta).
    """
    if image.ndim == 3:
        image = image[..., None]
    img, aff_ras, o_meta = orientation_ras(image, affine)
    img, aff_sp, s_meta = spacing_resample(img, aff_ras, pixdim, mode="bilinear")
    img = scale_intensity_range(img, a_min, a_max, b_min, b_max, clip=True)

    lab_out = None
    if label is not None:
        if label.ndim == 3:
            label = label[..., None]
        if resample_labels:
            lab, _, _ = orientation_ras(label, affine)
            lab, _, _ = spacing_resample(lab, aff_ras, pixdim, mode="nearest")
            lab_out = lab
        else:
            lab_out = label  # native grid

    if resample_labels and lab_out is not None:
        img, lab_out, c_meta = crop_foreground(img, lab_out)
    else:
        img, _, c_meta = crop_foreground(img)

    meta = CaseMeta(
        affine=affine,
        orientation=o_meta,
        spacing=s_meta,
        crop=c_meta,
        resample_labels=resample_labels,
    )
    return img.astype(np.float32), lab_out, meta


def invert_to_native(pred: np.ndarray, meta: CaseMeta, *, mode: str = "bilinear") -> np.ndarray:
    """Map a prediction volume (on the preprocessed grid, channels-last
    (X,Y,Z,K)) back to the native image grid — the MONAI Invertd equivalent
    (trainer_CTUNet.py:141-178, nearest_interp=False)."""
    out = invert_crop(pred, meta.crop)
    out = invert_spacing(out, meta.spacing, mode=mode)
    out = invert_orientation(out, meta.orientation)
    return out
