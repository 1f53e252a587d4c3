"""Native NIfTI-1 reader/writer (numpy only).

Replaces the reference's nibabel dependency (utils/data_utils.py LoadImaged,
nib.save in test scripts) with a self-contained implementation: supports
.nii / .nii.gz, the dtypes CT pipelines use, scl_slope/inter scaling, and
affine extraction with the standard sform > qform > pixdim precedence.

The port's own copy of ``hybrid_ctunet_tpu/data/nifti.py`` (numpy only; the port
imports nothing of the JAX package).
"""
from __future__ import annotations

import gzip
import struct
from typing import Optional, Tuple

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
    1024: np.int64,
    1280: np.uint64,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _quaternion_affine(hdr) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    pixdim = hdr["pixdim"]
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    spacing = np.array([pixdim[1], pixdim[2], pixdim[3] * qfac])
    aff = np.eye(4)
    aff[:3, :3] = R * spacing
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _parse_header(raw: bytes) -> dict:
    if len(raw) < 348:
        raise ValueError("truncated NIfTI header")
    (sizeof_hdr,) = struct.unpack("<i", raw[0:4])
    endian = "<"
    if sizeof_hdr != 348:
        (sizeof_hdr,) = struct.unpack(">i", raw[0:4])
        if sizeof_hdr != 348:
            raise ValueError("not a NIfTI-1 file")
        endian = ">"

    def u(fmt, off):
        return struct.unpack_from(endian + fmt, raw, off)

    hdr = {}
    hdr["endian"] = endian
    hdr["dim"] = u("8h", 40)
    hdr["datatype"] = u("h", 70)[0]
    hdr["bitpix"] = u("h", 72)[0]
    hdr["pixdim"] = np.array(u("8f", 76))
    hdr["vox_offset"] = u("f", 108)[0]
    hdr["scl_slope"] = u("f", 112)[0]
    hdr["scl_inter"] = u("f", 116)[0]
    hdr["qform_code"] = u("h", 252)[0]
    hdr["sform_code"] = u("h", 254)[0]
    hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"] = u("3f", 256)
    hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"] = u("3f", 268)
    hdr["srow_x"] = np.array(u("4f", 280))
    hdr["srow_y"] = np.array(u("4f", 296))
    hdr["srow_z"] = np.array(u("4f", 312))
    hdr["magic"] = raw[344:348]
    return hdr


def _affine_from_header(hdr) -> np.ndarray:
    if hdr["sform_code"] > 0:
        return np.vstack([hdr["srow_x"], hdr["srow_y"], hdr["srow_z"], [0, 0, 0, 1]])
    if hdr["qform_code"] > 0:
        return _quaternion_affine(hdr)
    aff = np.eye(4)
    aff[0, 0], aff[1, 1], aff[2, 2] = hdr["pixdim"][1:4]
    return aff


def load_nifti(path: str, *, dtype=None) -> Tuple[np.ndarray, np.ndarray]:
    """Load a .nii/.nii.gz volume. Returns (data[x,y,z,...], affine 4x4)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    hdr = _parse_header(raw[:348])
    ndim = hdr["dim"][0]
    shape = tuple(int(d) for d in hdr["dim"][1 : 1 + ndim])
    np_dtype = np.dtype(_DTYPES[hdr["datatype"]]).newbyteorder(hdr["endian"])
    off = int(hdr["vox_offset"])
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=off)
    data = data.reshape(shape, order="F")
    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if slope not in (0.0, 1.0) or inter not in (0.0,):
        if slope == 0.0:
            slope = 1.0
        data = data.astype(np.float32) * slope + inter
    if dtype is not None:
        data = data.astype(dtype)
    else:
        data = np.asarray(data)
    return data, _affine_from_header(hdr)


def save_nifti(path: str, data: np.ndarray, affine: Optional[np.ndarray] = None):
    """Write a .nii/.nii.gz with an sform affine (nib.save equivalent for the
    reference's mask export, test_CTUNet_final.py:606)."""
    if affine is None:
        affine = np.eye(4)
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype not in _DTYPE_CODES:
        data = data.astype(np.float32)
    code = _DTYPE_CODES[np.dtype(data.dtype)]

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    spacing = np.sqrt((np.asarray(affine)[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, *([1.0] * (7 - 3)))
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    struct.pack_into("<4f", hdr, 280, *np.asarray(affine)[0])
    struct.pack_into("<4f", hdr, 296, *np.asarray(affine)[1])
    struct.pack_into("<4f", hdr, 312, *np.asarray(affine)[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + np.asfortranarray(data).tobytes(order="F")
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(payload)
