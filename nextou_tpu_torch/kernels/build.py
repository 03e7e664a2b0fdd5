"""Build-at-first-use of the hand-written CUDA kernels.

Every kernel of the port is CUDA C++ under ``nextou_tpu_torch/csrc/``, one
shared library per source with a plain C interface, compiled by ``nvcc`` for
``sm_90a`` the first time a wrapper needs it and loaded with ``ctypes``. The
libraries go to ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``); a library's file name carries a hash of its source, of the
headers it includes and of the flags, so an edited source builds anew.

:data:`LIBRARIES` is the registry: the headers each source includes and the
argument types of the functions it exports. :func:`library` builds and loads
one; :func:`build_kernels` builds all of them, every ``nvcc`` started
together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
# listed in .gitignore; the checkout builds its own libraries at first use
_BUILD_DIR = _CSRC.parents[1] / "build" / "kernels"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_PTR, _INT = ctypes.c_void_p, ctypes.c_int


class Library(NamedTuple):
    """One ``csrc/{name}.cu``: the headers it includes (hashed with it) and
    its exported functions' argument types. Every function returns the
    ``cudaError_t`` of its launch as an ``int``."""

    headers: tuple[str, ...]
    functions: dict[str, list]


_MMA = ("mma_bf16.cuh",)
_SELECT = ("knn_select.cuh", *_MMA)
_SM90 = ("conv_sm90.cuh",)
LIBRARIES: dict[str, Library] = {
    "knn_max": Library(_SELECT, {
        "knn_max_forward": [_PTR] * 5 + [_INT] * 6 + [_PTR],
        "knn_max_plan": [_INT] * 7 + [_PTR],
    }),
    "knn_max_idx": Library(_SELECT, {
        "knn_max_idx_forward": [_PTR] * 6 + [_INT] * 6 + [_PTR],
        "knn_indices_forward": [_PTR] * 4 + [_INT] * 5 + [_PTR],
    }),
    "knn_max_bwd": Library((), {
        "knn_max_backward": [_PTR] * 6 + [_INT] * 8 + [_PTR],
        "knn_max_bwd_plan": [_INT] * 6 + [_PTR],
    }),
    "conv3d": Library(_SM90, {
        "conv3d_forward": [_PTR] * 4 + [_INT] * 13 + [_PTR],
        "conv3d_plan": [_INT] * 12 + [_PTR],
        "conv3d_pack_weights": [_PTR] * 2 + [_INT] * 12 + [_PTR],
    }),
    "conv_cl": Library(_SM90, {
        "conv_cl_forward": [_PTR] * 4 + [_INT] * 13 + [_PTR],
        "conv_cl_plan": [_INT] * 12 + [_PTR],
        "conv_cl_pack_weights": [_PTR] * 2 + [_INT] * 12 + [_PTR],
    }),
    "conv_probe": Library((), {
        "conv_probe_forward": [_PTR] * 3 + [_INT] * 5 + [_PTR],
        "conv_probe_empty": [_PTR],
    }),
    "knn_dissect": Library(_SELECT, {"knn_dissect_forward": [_PTR] * 5 + [_INT] * 6 + [_PTR]}),
}


def _library_path(name: str) -> Path:
    """Where the library of ``csrc/{name}.cu`` goes: one file per content of
    the source, its headers and the flags."""
    content = (_CSRC / f"{name}.cu").read_bytes()
    for header in LIBRARIES[name].headers:
        content += (_CSRC / header).read_bytes()
    tag = hashlib.sha256(content + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}_{tag}.so"


def _tmp_path(lib_path: Path) -> Path:
    return lib_path.with_suffix(f".tmp{os.getpid()}")


def _start_build(name: str) -> subprocess.Popen | None:
    """Start ``nvcc`` on one source unless its library is there already."""
    lib_path = _library_path(name)
    if lib_path.exists():
        return None
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(f"csrc/{name}.cu needs nvcc to build; none found")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [nvcc, *_NVCC_FLAGS, "-o", str(_tmp_path(lib_path)), str(_CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _finish_build(name: str, proc: subprocess.Popen | None) -> str:
    lib_path = _library_path(name)
    if proc is None:
        return f"{lib_path.name}: cached"
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on csrc/{name}.cu:\n{log}")
    # atomic: a concurrent build never sees half a file
    os.replace(_tmp_path(lib_path), lib_path)
    return log


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """Build (once per source content) and load one library."""
    _finish_build(name, _start_build(name))
    lib = ctypes.CDLL(str(_library_path(name)))
    for fn_name, argtypes in LIBRARIES[name].functions.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_kernels() -> dict[str, str]:
    """Build every kernel library, one ``nvcc`` per source and all started
    together, and load them. Returns nvcc's report per library."""
    procs = {name: _start_build(name) for name in LIBRARIES}
    logs = {name: _finish_build(name, proc) for name, proc in procs.items()}
    for name in LIBRARIES:
        library(name)
    return logs


def ptr(t):
    """A tensor's device address for a ``c_void_p`` argument; ``None`` stays."""
    return None if t is None else t.data_ptr()


def check_tensors(name: str, tensors: dict, dtypes: dict, shapes: dict) -> torch.device:
    """Raise on what a kernel does not take: every tensor on one CUDA device,
    contiguous, of its expected dtype and shape (``None`` entries skipped)."""
    tensors = {n: t for n, t in tensors.items() if t is not None}
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda" or any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    for n, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {n} must be contiguous")
        if t.dtype not in dtypes[n]:
            raise ValueError(f"{name}: {n} has dtype {t.dtype}, takes {dtypes[n]}")
        if tuple(t.shape) != tuple(shapes[n]):
            raise ValueError(f"{name}: {n} has shape {tuple(t.shape)}, takes {shapes[n]}")
    return dev
