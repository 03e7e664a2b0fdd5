"""Minimal image IO: NIfTI-1 (.nii / .nii.gz) and NumPy formats.

Counterpart of ``nextou_tpu/data/io.py``, carried over as it is (numpy
only). The reference datasets ship as NIfTI via SimpleITK; this is a small,
dependency-free NIfTI-1 reader/writer (header struct per the NIfTI-1 spec).
Arrays come back as stored: Fortran order read into axes (x, y, z), with the
spacing in the same order; the plans' ``transpose_forward`` puts z first.
Supports the subset medical segmentation needs: scalar 3D/4D volumes, common
dtypes, pixdim spacing, qform/sform ignored beyond spacing (images are
assumed axis-aligned after nnU-Net-style transpose).
"""

from __future__ import annotations

import gzip
import struct

import numpy as np

_NIFTI1_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_DTYPE_CODES = {np.dtype(v): k for k, v in _NIFTI1_DTYPES.items()}


def _open(path: str, mode: str):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def read_nifti(path: str) -> tuple[np.ndarray, tuple[float, ...]]:
    """Returns (array (possibly >3D, as stored), voxel spacing (per dim))."""
    with _open(path, "rb") as f:
        hdr = f.read(348)
        if len(hdr) < 348:
            raise ValueError(f"{path}: truncated NIfTI header")
        sizeof_hdr = struct.unpack("<i", hdr[0:4])[0]
        endian = "<"
        if sizeof_hdr != 348:
            sizeof_hdr = struct.unpack(">i", hdr[0:4])[0]
            if sizeof_hdr != 348:
                raise ValueError(f"{path}: not a NIfTI-1 file")
            endian = ">"
        magic = hdr[344:348]
        if magic[:2] not in (b"n+", b"ni"):
            raise ValueError(f"{path}: bad NIfTI magic {magic!r}")
        dim = struct.unpack(endian + "8h", hdr[40:56])
        ndim = dim[0]
        shape = tuple(dim[1 : 1 + ndim])
        datatype = struct.unpack(endian + "h", hdr[70:72])[0]
        if datatype not in _NIFTI1_DTYPES:
            raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
        dtype = np.dtype(_NIFTI1_DTYPES[datatype]).newbyteorder(endian)
        pixdim = struct.unpack(endian + "8f", hdr[76:108])
        spacing = tuple(float(p) for p in pixdim[1 : 1 + min(ndim, 3)])
        vox_offset = struct.unpack(endian + "f", hdr[108:112])[0]
        scl_slope = struct.unpack(endian + "f", hdr[112:116])[0]
        scl_inter = struct.unpack(endian + "f", hdr[116:120])[0]

        f.seek(int(vox_offset))
        count = int(np.prod(shape))
        data = np.frombuffer(
            f.read(count * dtype.itemsize), dtype=dtype, count=count
        )
        # NIfTI stores Fortran order (x fastest)
        arr = data.reshape(shape, order="F")
        if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
            slope = scl_slope if scl_slope != 0.0 else 1.0
            arr = arr.astype(np.float32) * slope + scl_inter
        return np.ascontiguousarray(arr), spacing


def write_nifti(path: str, arr: np.ndarray, spacing=None):
    arr = np.asarray(arr)
    code = _DTYPE_CODES.get(np.dtype(arr.dtype.newbyteorder("=")))
    if code is None:
        arr = arr.astype(np.float32)
        code = 16
    ndim = arr.ndim
    dim = [ndim] + list(arr.shape) + [1] * (7 - ndim)
    pixdim = [1.0] + (
        list(spacing) if spacing is not None else [1.0] * ndim
    ) + [1.0] * (7 - ndim)
    pixdim = pixdim[:8]

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, arr.dtype.itemsize * 8)  # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    # sform: identity-ish with spacing on the diagonal
    struct.pack_into("<h", hdr, 254, 1)  # sform_code
    sp = pixdim[1:4]
    struct.pack_into("<4f", hdr, 280, sp[0], 0, 0, 0)  # srow_x
    struct.pack_into("<4f", hdr, 296, 0, sp[1], 0, 0)  # srow_y
    struct.pack_into("<4f", hdr, 312, 0, 0, sp[2], 0)  # srow_z
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.asfortranarray(arr).tobytes(order="F"))


def read_image(path: str) -> tuple[np.ndarray, tuple[float, ...]]:
    """Dispatch by extension: .nii/.nii.gz/.npy/.npz."""
    if path.endswith((".nii", ".nii.gz")):
        return read_nifti(path)
    if path.endswith(".npy"):
        return np.load(path), ()
    if path.endswith(".npz"):
        with np.load(path) as z:
            key = "data" if "data" in z.files else z.files[0]
            return z[key], tuple(z["spacing"]) if "spacing" in z.files else ()
    raise ValueError(f"unsupported image format: {path}")
