"""A NIfTI-1 writer for the benchmark's cases: uncompressed ``.nii``, an
sform affine, little-endian, so that writing a case costs its bytes and
nothing more."""
from __future__ import annotations

import struct

import numpy as np

_CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.int32): 8,
          np.dtype(np.float32): 16, np.dtype(np.float64): 64}


def save(path, data: np.ndarray, affine: np.ndarray) -> None:
    data = np.asarray(data)
    code = _CODES[data.dtype]
    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, data.ndim, *data.shape, *([1] * (7 - data.ndim)))
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    spacing = np.sqrt((np.asarray(affine)[:3, :3] ** 2).sum(axis=0))
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    for row in range(3):
        struct.pack_into("<4f", hdr, 280 + 16 * row, *np.asarray(affine, np.float64)[row])
    hdr[344:348] = b"n+1\x00"
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.asfortranarray(data.astype(data.dtype.newbyteorder("<"))).tobytes(order="F"))
