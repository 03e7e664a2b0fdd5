"""Window partition / reverse for the Swin-style local GNN (channels-last).

Counterpart of ``nextou_tpu/core/window.py``: pure reshapes and permutes.
Shapes (3D): ``(B, S, H, W, C)`` <-> ``(B * nW, ws, hs, ws_w, C)``, the window
grid laid out batch-major ``(b, s_blk, h_blk, w_blk)`` like upstream's
``(b s h w)`` flattening.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def window_partition(x: torch.Tensor, window_size: Sequence[int]) -> torch.Tensor:
    """``(B, *spatial, C)`` -> ``(B * num_windows, *window_size, C)``."""
    spatial = x.shape[1:-1]
    B, C = x.shape[0], x.shape[-1]
    nd = len(window_size)
    assert len(spatial) == nd, (spatial, window_size)
    shape = [B]
    for s, w in zip(spatial, window_size):
        assert s % w == 0, f"window {window_size} must divide spatial {spatial}"
        shape += [s // w, w]
    x = x.reshape(*shape, C)  # (B, n1, w1, n2, w2, ..., C)
    perm = (
        [0]
        + [1 + 2 * i for i in range(nd)]
        + [2 + 2 * i for i in range(nd)]
        + [1 + 2 * nd]
    )
    n_windows = math.prod(s // w for s, w in zip(spatial, window_size))
    return x.permute(perm).reshape(B * n_windows, *window_size, C)


def window_reverse(
    windows: torch.Tensor, window_size: Sequence[int], spatial: Sequence[int]
) -> torch.Tensor:
    """Inverse of :func:`window_partition`: -> ``(B, *spatial, C)``."""
    nd = len(window_size)
    C = windows.shape[-1]
    blocks = [s // w for s, w in zip(spatial, window_size)]
    B = windows.shape[0] // math.prod(blocks)
    x = windows.reshape(B, *blocks, *window_size, C)
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 1 + nd + i]
    perm.append(1 + 2 * nd)
    return x.permute(perm).reshape(B, *spatial, C)
