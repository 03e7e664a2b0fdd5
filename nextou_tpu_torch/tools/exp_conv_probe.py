"""The conv design's row-patch probe on a CUDA card.

    python -m nextou_tpu_torch.tools.exp_conv_probe

Counterpart of the JAX package's ``tools/exp_mosaic_probe.py``, which asked
whether Mosaic supports the steps of a row-tiled conv kernel. The function is
the same: the three kh-shifted row groups of a ``((TH+2)*C, W)`` slab as a
``(TH, 3C, W)`` patch buffer, ``TH`` products with a ``(3C, Co)`` weight
matrix, stored as ``(TH, W, Co)`` or transposed as ``(TH, Co, W)``; at
``TH=4, C=Co=33, W=256`` in f32. The kernel is ``csrc/conv_probe.cu``. Both
output orders are held against the numpy oracle of the JAX tool (max error
under 1e-4: an f32 sum over 99 terms in another order) and timed.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from nextou_tpu_torch.kernels.build import check_tensors, library, ptr
from nextou_tpu_torch.tools.timing import card, cuda_ms, require_card

TH, C, W, CO = 4, 33, 256, 33
TOLERANCE = 1e-4
_F32 = (torch.float32,)


def conv_probe_reference(x: torch.Tensor, w: torch.Tensor, transpose_out: bool) -> torch.Tensor:
    """Plain version: ``x ((TH+2)*C, W)``, ``w (3C, Co)`` ->
    ``(TH, W, Co)``, or ``(TH, Co, W)`` with ``transpose_out``."""
    c = w.shape[0] // 3
    x3 = x.reshape(-1, c, x.shape[1])
    th = x3.shape[0] - 2
    pat = torch.cat([x3[k: k + th] for k in range(3)], dim=1)  # (TH, 3C, W)
    return torch.einsum("hkw,ko->how" if transpose_out else "hkw,ko->hwo", pat, w)


def conv_probe_cuda(x: torch.Tensor, w: torch.Tensor, transpose_out: bool) -> torch.Tensor:
    """Launch the probe kernel on f32 ``x ((TH+2)*C, W)`` and ``w (3C, Co)``.

    ``conv_probe_cuda.launches`` counts the launches.
    """
    k, co = w.shape
    c = k // 3
    th, width = x.shape[0] // c - 2, x.shape[1]
    if k != 3 * c or th < 1:
        raise ValueError(f"conv_probe_cuda: w {tuple(w.shape)} is not (3C, Co)")
    dev = check_tensors("conv_probe_cuda", {"x": x, "w": w}, {"x": _F32, "w": _F32},
                        {"x": ((th + 2) * c, width), "w": (k, co)})
    out = torch.empty((th, co, width) if transpose_out else (th, width, co),
                      dtype=torch.float32, device=dev)
    lib = library("conv_probe")
    with torch.cuda.device(dev):
        rc = lib.conv_probe_forward(ptr(x), ptr(w), ptr(out), th, c, width, co,
                                    int(transpose_out), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"conv_probe_cuda: launch failed with CUDA error {rc}")
    conv_probe_cuda.launches += 1
    return out


conv_probe_cuda.launches = 0


def probe_inputs() -> tuple[np.ndarray, np.ndarray]:
    """The JAX tool's inputs: seeds 0 and 1, the weights scaled by 0.1."""
    x = np.random.default_rng(0).standard_normal(((TH + 2) * C, W)).astype(np.float32)
    w = (np.random.default_rng(1).standard_normal((3 * C, CO)) * 0.1).astype(np.float32)
    return x, w


def numpy_oracle(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """``(TH, W, Co)``, as the JAX tool computes it."""
    x3 = x.reshape(TH + 2, C, W)
    pat = np.concatenate([x3[k: k + TH] for k in range(3)], axis=1)
    return np.einsum("hkw,ko->hwo", pat, w)


def run(dev, transpose_out: bool) -> dict:
    """One output order: the error against the oracle, and the times of the
    kernel and of its plain version. Raises outside the tolerance."""
    x, w = probe_inputs()
    want = numpy_oracle(x, w)
    xt, wt = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    got = conv_probe_cuda(xt, wt, transpose_out).cpu().numpy()
    if transpose_out:
        got = got.transpose(0, 2, 1)
    err = float(np.max(np.abs(got - want)))
    ms = cuda_ms(lambda: conv_probe_cuda(xt, wt, transpose_out), iters=20)
    plain_ms = cuda_ms(lambda: conv_probe_reference(xt, wt, transpose_out), iters=20)
    print(f"transpose_out={transpose_out}: max err {err:.2e}, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms", flush=True)
    if not err < TOLERANCE:
        raise AssertionError(f"the probe kernel is {err:.2e} off its oracle")
    return {"err": err, "ms": ms, "plain_ms": plain_ms}


def main() -> int:
    if not require_card("exp_conv_probe"):
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card())
    run(dev, False)
    run(dev, True)
    print("ALL PROBES PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
