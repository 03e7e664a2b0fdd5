"""Fused kNN + neighbour-max: the dispatcher, its plain version and K1.

The hot op of every grapher: L2-normalize the node features, squared
distances (+ relative-position bias), k nearest by (distance, index), and
the per-channel max over those k rows of the raw values. MRConv needs only
that max, since ``max_j (x_j - x_i) = (max_j x_j) - x_i``.

- :func:`knn_max_neighbors_reference` is the plain PyTorch version
  (counterpart of ``nextou_tpu/kernels/knn.py::knn_max_neighbors_reference``).
- :func:`knn_max_cuda` launches K1, the hand-written CUDA kernel in
  ``nextou_tpu_torch/csrc/knn_max.cu``, built with ``nvcc`` at first use.
- :func:`knn_max_neighbors` dispatches on the tensor's device: a CPU tensor
  goes to the plain version, a CUDA tensor to K1 or raises. There is no
  fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from nextou_tpu_torch.core.graph import (
    batched_index_select,
    dense_knn,
    l2_normalize,
)

_PKG = Path(__file__).resolve().parents[1]
_SOURCE = _PKG / "csrc" / "knn_max.cu"
# listed in .gitignore; the checkout builds its own library at first use
_BUILD_DIR = _PKG.parent / "build" / "kernels"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
K_MAX = 32  # K1 keeps the running top-k in one warp's lanes


def coord_dtype(dtype: torch.dtype) -> torch.dtype:
    """Dtype the normalized coordinates are selected in: bf16 for a bf16
    model (inference), f32 for anything else (``_coord_dtype`` in the JAX
    package, inference branch)."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _normalized(x, y):
    cdt = coord_dtype(x.dtype)
    xn = l2_normalize(x.float()).to(cdt)
    yn = xn if y is None else l2_normalize(y.float()).to(cdt)
    return xn, yn


def knn_max_neighbors_reference(
    x: torch.Tensor,
    k: int,
    y: torch.Tensor | None = None,
    relative_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version: normalize, distances, stable-sort top-k, gather, max.

    Returns ``(B, N, C)`` in the value dtype (``y``'s, else ``x``'s), like
    the JAX reference helper.
    """
    xn, yn = _normalized(x, y)
    idx = dense_knn(xn, k, y=None if y is None else yn, relative_pos=relative_pos)
    vals = x if y is None else y
    return torch.amax(batched_index_select(vals, idx), dim=2)


@functools.cache
def _library() -> tuple[ctypes.CDLL, str]:
    """Build K1 from the checkout's source (once per source content) and
    load it. Returns the library and the compiler's report."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"libknn_max_{tag}.so"
    log = f"{lib_path.name}: cached"
    if not lib_path.exists():
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("K1 needs nvcc to build csrc/knn_max.cu; none found")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".tmp{os.getpid()}")
        proc = subprocess.run(
            [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {_SOURCE}:\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)  # atomic: concurrent builders never see half a file
        log = proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.knn_max_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, log


def build_knn_max() -> str:
    """Build (or find) and load K1; returns nvcc's report for the log."""
    return _library()[1]


def knn_max_cuda(
    xn: torch.Tensor,
    yn: torch.Tensor,
    yv: torch.Tensor,
    rel: torch.Tensor | None,
    k: int,
) -> torch.Tensor:
    """Launch K1 on normalized coordinates ``xn (B, N, C)``, ``yn (B, M, C)``
    and raw values ``yv (B, M, C)``, all three bf16 or all three f32, and an
    optional ``(N, M)`` f32 bias. Returns ``(B, N, C)`` f32.

    ``knn_max_cuda.launches`` counts the launches.
    """
    B, N, C = xn.shape
    M = yn.shape[1]
    dev = xn.device
    tensors = (xn, yn, yv) if rel is None else (xn, yn, yv, rel)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("knn_max_cuda: every tensor must be on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("knn_max_cuda: tensors must be contiguous")
    if xn.dtype not in (torch.bfloat16, torch.float32) or not xn.dtype == yn.dtype == yv.dtype:
        raise ValueError(f"knn_max_cuda: dtypes {xn.dtype}/{yn.dtype}/{yv.dtype}")
    if yn.shape != (B, M, C) or yv.shape != (B, M, C):
        raise ValueError(f"knn_max_cuda: shapes {xn.shape} {yn.shape} {yv.shape}")
    if rel is not None and (rel.shape != (N, M) or rel.dtype != torch.float32):
        raise ValueError(f"knn_max_cuda: bias {rel.shape} {rel.dtype}")
    if not 1 <= k <= min(K_MAX, M):
        raise ValueError(f"knn_max_cuda: k={k} outside [1, min({K_MAX}, M={M})]")
    lib, _ = _library()
    out = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.knn_max_forward(
            xn.data_ptr(), yn.data_ptr(), yv.data_ptr(),
            None if rel is None else rel.data_ptr(), out.data_ptr(),
            B, N, M, C, k, int(xn.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"knn_max_cuda: launch failed with CUDA error {rc}")
    knn_max_cuda.launches += 1
    return out


knn_max_cuda.launches = 0


def knn_max_neighbors(
    x: torch.Tensor,
    k: int,
    y: torch.Tensor | None = None,
    relative_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-channel max over the k nearest neighbours of each node.

    Args:
        x: ``(B, N, C)`` query/node features (raw; normalized here).
        k: neighbours per node.
        y: optional ``(B, M, C)`` candidate set (raw); defaults to ``x``.
        relative_pos: optional ``(N, M)`` additive distance bias.
    Returns:
        ``(B, N, C)`` in ``x.dtype``.

    A CPU tensor goes to the plain version. A CUDA tensor goes to K1; what K1
    does not take (a per-batch bias, ``k > min(32, M)``, autograd) raises.
    """
    if x.device.type == "cpu":
        return knn_max_neighbors_reference(x, k, y, relative_pos).to(x.dtype)
    if x.device.type != "cuda":
        raise NotImplementedError(f"knn_max_neighbors on {x.device.type}")
    vals = x if y is None else y
    N, M = x.shape[1], vals.shape[1]
    if relative_pos is not None and relative_pos.dim() != 2:
        raise NotImplementedError("K1 takes one (N, M) bias shared by the batch")
    if k > min(K_MAX, M):
        raise NotImplementedError(f"K1 takes k <= min({K_MAX}, M); got k={k}, M={M}")
    if x.requires_grad or vals.requires_grad:
        raise NotImplementedError("K1 has no backward yet (K3/K4)")
    xn, yn = _normalized(x, y)
    # the cast commutes with the max (rounding is monotonic): exact for x and
    # y in bf16 or f32
    yv = vals.to(xn.dtype)
    rel = None
    if relative_pos is not None:
        rel = relative_pos.to(torch.float32).expand(N, M).contiguous()
    out = knn_max_cuda(
        xn.contiguous(), yn.contiguous(), yv.contiguous(), rel, k
    )
    return out.to(x.dtype)
