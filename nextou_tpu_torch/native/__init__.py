"""ctypes bindings for the host resampler (``resample.cpp`` beside this file).

Counterpart of ``nextou_tpu/native/__init__.py``, with its own copy of the
source. Each entry point has the scipy call it replaces as its contract:
``zoom`` (to an explicit shape), ``affine_transform`` (orders 0 and 1,
``reflect`` and ``constant``) and ``gaussian_filter``, to within f32
rounding. The host augmentation (``data/augment.py``) runs on it.

The library is built with ``g++`` the first time an entry point needs it,
into ``build/native/`` at the root of the checkout (listed in
``.gitignore``), one file per content of the source; importing this module
builds nothing. A failed build raises: there is no fallback to scipy.

Threading: each call splits its lines or slices over ``os.cpu_count()``
threads (ctypes releases the GIL during the call).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("resample.cpp")
_BUILD_DIR = _SRC.parents[2] / "build" / "native"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "nxt_zoom_f32": [_F32P, _I64P, _F32P, _I64P, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    "nxt_affine_f32": [_F32P, _I64P, ctypes.c_int, _F64P, _F64P, _F32P, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int],
    "nxt_gaussian_f32": [_F32P, _I64P, ctypes.c_int, ctypes.c_double, _F32P, ctypes.c_int],
}


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source content) and load the library."""
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libresample_{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) on {_SRC.name}:\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _threads() -> int:
    return max(1, os.cpu_count() or 1)


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def _i64(shape) -> tuple[np.ndarray, object]:
    a = np.asarray(shape, dtype=np.int64)
    return a, a.ctypes.data_as(_I64P)


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed (rc={rc})")


def zoom_to_shape(x: np.ndarray, out_shape, order: int) -> np.ndarray:
    """``scipy.ndimage.zoom`` to an explicit output shape (orders 0, 1, 3)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(tuple(out_shape), np.float32)
    _, ip = _i64(x.shape)
    _, op = _i64(out.shape)
    _check(library().nxt_zoom_f32(_f32p(x), ip, _f32p(out), op, x.ndim, int(order), _threads()),
           "nxt_zoom_f32")
    return out


def affine_transform(x: np.ndarray, mat: np.ndarray, offset: np.ndarray, order: int,
                     mode: str, cval: float = 0.0) -> np.ndarray:
    """``scipy.ndimage.affine_transform`` of a 2D or 3D array (orders 0 and
    1; ``reflect`` or ``constant``)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    mat = np.ascontiguousarray(mat, dtype=np.float64)
    off = np.ascontiguousarray(offset, dtype=np.float64)
    out = np.empty_like(x)
    _, sp = _i64(x.shape)
    _check(library().nxt_affine_f32(
        _f32p(x), sp, x.ndim, mat.ctypes.data_as(_F64P), off.ctypes.data_as(_F64P), _f32p(out),
        int(order), {"reflect": 0, "constant": 1}[mode], float(cval), _threads(),
    ), "nxt_affine_f32")
    return out


def gaussian_filter(x: np.ndarray, sigma: float) -> np.ndarray:
    """``scipy.ndimage.gaussian_filter`` (``reflect``, truncate 4)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty_like(x)
    _, sp = _i64(x.shape)
    _check(library().nxt_gaussian_f32(_f32p(x), sp, x.ndim, float(sigma), _f32p(out), _threads()),
           "nxt_gaussian_f32")
    return out
