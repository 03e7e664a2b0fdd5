"""Dissect the fused kNN + neighbour-max kernel's time at its two hot shapes.

    python -m nextou_tpu_torch.tools.exp_knn_dissect

Counterpart of the JAX package's ``tools/exp_knn_dissect.py``. The kernel
(``csrc/knn_dissect.cu``) is K1's body with one mechanism taken out per mode;
the outputs mean nothing except in ``full``:

    full      the product of distances, the running top-k, the gather and max
    half_k    the same with k / 2 (how the time grows with k)
    nosel     no gather: product and top-k alone
    nominext  no top-k: product, then the gather and max of candidates 0..k-1
    distonly  the product alone

at the stage-3 pool grapher's shape (2, 10752, 1344, 264, k 28) and the
stage-2 Swin windows' (1024, 168, 168, 132, k 7), f32 coordinates, bf16
values and a zero bias, as there. ``full`` is held against the plain version
(``knn_max_neighbors_reference`` on f32 coordinates) under K1's rule: at
most 0.1% of the rows may differ; the times are by CUDA events.
"""

from __future__ import annotations

import sys

import torch

from nextou_tpu_torch.kernels.build import check_tensors, library, ptr
from nextou_tpu_torch.kernels.knn import K_MAX, _normalized, knn_max_neighbors_reference
from nextou_tpu_torch.tools.timing import card, cuda_ms, require_card

MODES = {"full": 0, "nosel": 1, "nominext": 2, "distonly": 3}
# tag, B, N, M, C, k
SHAPES = [
    ("s3 pool", 2, 10752, 1344, 264, 28),
    ("s2 swin", 1024, 168, 168, 132, 7),
]
MAX_ROWS_OFF = 1e-3
_F32 = (torch.float32,)


def knn_dissect_cuda(
    xn: torch.Tensor, yn: torch.Tensor, yv: torch.Tensor, rel: torch.Tensor, k: int, mode: str
) -> torch.Tensor:
    """Launch the dissection kernel in ``mode`` on f32 coordinates
    ``xn (B, N, C)``, ``yn (B, M, C)``, bf16 values ``yv (B, M, C)`` and an
    ``(N, M)`` f32 bias. Returns ``(B, N, C)`` f32: in mode ``full`` the
    per-channel max over the k nearest candidates' values.

    ``knn_dissect_cuda.launches`` counts the launches.
    """
    B, N, C = xn.shape
    M = yn.shape[1]
    dev = check_tensors(
        "knn_dissect_cuda", {"xn": xn, "yn": yn, "yv": yv, "rel": rel},
        {"xn": _F32, "yn": _F32, "yv": (torch.bfloat16,), "rel": _F32},
        {"xn": (B, N, C), "yn": (B, M, C), "yv": (B, M, C), "rel": (N, M)},
    )
    if not 1 <= k <= min(K_MAX, M):
        raise ValueError(f"knn_dissect_cuda: k={k} outside [1, min({K_MAX}, M={M})]")
    out = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    lib = library("knn_dissect")
    with torch.cuda.device(dev):
        rc = lib.knn_dissect_forward(
            ptr(xn), ptr(yn), ptr(yv), ptr(rel), ptr(out), B, N, M, C, k, MODES[mode],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"knn_dissect_cuda: launch failed with CUDA error {rc}")
    knn_dissect_cuda.launches += 1
    return out


knn_dissect_cuda.launches = 0


def dissect_inputs(B, N, M, C, dev, seed=0):
    """Seeded bf16 features ``x (B, N, C)``, ``y (B, M, C)`` and what the
    kernel reads of them: their normalized f32 coordinates, ``y`` as the
    values, a zero bias."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, N, C, generator=gen, device=dev).bfloat16()
    y = torch.randn(B, M, C, generator=gen, device=dev).bfloat16()
    xn, yn = _normalized(x, y, train=True)
    rel = torch.zeros(N, M, device=dev)
    return x, y, xn.contiguous(), yn.contiguous(), rel


def bench_shape(tag, B, N, M, C, k, dev) -> dict:
    """Hold ``full`` against the plain version, then time the five modes.
    Returns ``{mode: ms}`` plus ``plain_ms`` and ``rows_off`` (the share)."""
    x, y, xn, yn, rel = dissect_inputs(B, N, M, C, dev)
    got = knn_dissect_cuda(xn, yn, y, rel, k, "full")
    torch.cuda.synchronize()
    want = knn_max_neighbors_reference(x, k, y, rel, train=True).float()
    rows_off = (got != want).any(-1).float().mean().item()
    err = (got - want).abs().max().item()
    print(f"-- {tag}: B={B} N={N} M={M} C={C} k={k}: full against the plain version: "
          f"rows off {rows_off:.2e}, max|err| {err:.3g}", flush=True)
    if rows_off > MAX_ROWS_OFF:
        raise AssertionError(f"mode full disagrees with the plain version at {tag}")
    times = {"rows_off": rows_off, "max_abs_err": err}
    for mode, kk in [("full", k), ("half_k", max(1, k // 2)), ("nosel", k),
                     ("nominext", k), ("distonly", k)]:
        kernel_mode = "full" if mode == "half_k" else mode
        times[mode] = cuda_ms(lambda: knn_dissect_cuda(xn, yn, y, rel, kk, kernel_mode))
        print(f"  {mode:9s} k={kk:3d}: {times[mode]:7.3f} ms", flush=True)
    times["plain_ms"] = cuda_ms(lambda: knn_max_neighbors_reference(x, k, y, rel, train=True))
    print(f"  plain version: {times['plain_ms']:7.3f} ms", flush=True)
    return times


def main() -> int:
    if not require_card("exp_knn_dissect"):
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card())
    for shape in SHAPES:
        bench_shape(*shape, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
