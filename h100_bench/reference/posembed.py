"""The graphers' relative-position kNN bias for the reference, worked out
from the published recipe (upstream NexToU ``pos_embed.py``, the MAE
sin-cos embedding; ``NexToU_Encoder_Decoder.py:728-742``): the Gram matrix
``2 E E^T / C`` of the sin-cos embedding on the nearest integer grid,
resized to ``(n, m)`` as ``F.interpolate(mode='bicubic',
align_corners=False)`` resizes (Keys' cubic, A = -0.75, half-pixel
centres, clamped borders), one axis after the other with the source
positions in float64 and the taps in float32, and negated. Built on the
device the reference runs on.
"""

from __future__ import annotations

import numpy as np
import torch


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def _sincos(dim: int, grid: int, dims: int) -> np.ndarray:
    coords = np.arange(grid, dtype=np.float32)
    mesh = np.stack(np.meshgrid(*([coords] * dims)), axis=0)
    return np.concatenate([_sincos_1d(dim // dims, mesh[i]) for i in range(dims)], axis=1)


_A = -0.75


def _resize_rows(x: torch.Tensor, out: int) -> torch.Tensor:
    """Bicubic resize of ``x``'s first axis to ``out`` rows."""
    n = x.shape[0]
    if n == out:
        return x
    src = (torch.arange(out, dtype=torch.float64, device=x.device) + 0.5) * (n / out) - 0.5
    i0 = torch.floor(src)
    t = src - i0

    def near(d):  # |d| <= 1
        return ((_A + 2.0) * d - (_A + 3.0)) * d * d + 1.0

    def far(d):  # 1 < |d| < 2
        return ((_A * d - 5.0 * _A) * d + 8.0 * _A) * d - 4.0 * _A

    w = torch.stack([far(t + 1.0), near(t), near(1.0 - t), far(2.0 - t)], -1).float()
    taps = (i0.long()[:, None] + torch.arange(-1, 3, device=x.device)).clamp(0, n - 1)
    return torch.einsum("ot,ot...->o...", w, x[taps])


def relative_pos_bias(channels: int, n: int, m: int, dims: int, device="cpu") -> torch.Tensor:
    """``(n, m)`` f32 on ``device``: the negated, resized relative-position
    Gram matrix."""
    grid = int(n ** (1.0 / dims))
    e = torch.from_numpy(_sincos(channels, grid, dims)).to(device)
    rel = (2.0 * (e @ e.T) / e.shape[1]).float()
    rel = _resize_rows(rel, n)
    return -_resize_rows(rel.T, m).T
