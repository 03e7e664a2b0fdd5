"""Sin-cos positional embeddings and the graphers' relative-position bias (NumPy).

Carried over from ``nextou_tpu/core/pos_embed.py`` (importing that module
would load jax through ``nextou_tpu/core/__init__.py``). Host-side and
construction-time only. Reproduces upstream NexToU's ``pos_embed.py``
(the MAE/MoCo-v3 recipe), including the quirks that matter for parity:

- 2D: grid built with ``meshgrid(w, h)`` ('xy' indexing, w varies first);
- 3D: grid built with ``meshgrid(d, w, h)``;
- relative form: ``2 * E @ E.T / embed_dim``.

The graphers store the *negated* relative matrix, bicubic-resized to the
actual (N, N_reduced) node counts (upstream
``NexToU_Encoder_Decoder.py:728-742``): :func:`relative_pos_bias`.
"""

from __future__ import annotations

import functools
import time

import numpy as np

from nextou_tpu_torch.core.resize import bicubic_resize_2d
from nextou_tpu_torch.trace import count


def get_1d_sincos_pos_embed(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim) [sin || cos] embedding."""
    assert embed_dim % 2 == 0, embed_dim
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid_size**2, embed_dim) embedding over a square 2D grid."""
    assert embed_dim % 2 == 0, embed_dim
    coords = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(coords, coords), axis=0)  # w first ('xy')
    embs = [get_1d_sincos_pos_embed(embed_dim // 2, grid[i]) for i in range(2)]
    return np.concatenate(embs, axis=1)


def get_3d_sincos_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """(grid_size**3, embed_dim) embedding over a cubic 3D grid."""
    assert embed_dim % 3 == 0, embed_dim
    coords = np.arange(grid_size, dtype=np.float32)
    grid = np.stack(np.meshgrid(coords, coords, coords), axis=0)
    embs = [get_1d_sincos_pos_embed(embed_dim // 3, grid[i]) for i in range(3)]
    return np.concatenate(embs, axis=1)


def get_2d_relative_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    e = get_2d_sincos_pos_embed(embed_dim, grid_size)
    return 2.0 * (e @ e.T) / e.shape[1]


def get_3d_relative_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    e = get_3d_sincos_pos_embed(embed_dim, grid_size)
    return 2.0 * (e @ e.T) / e.shape[1]


@functools.lru_cache(maxsize=16)
def relative_pos_bias(
    channels: int, n: int, n_reduced: int, spatial_dims: int
) -> np.ndarray:
    """The additive kNN distance bias used by the graphers.

    Builds the relative Gram matrix on the nearest integer grid
    (``int(n ** (1/d))``, truncated exactly as upstream does), bicubic-resizes
    it to ``(n, n_reduced)`` and negates it, so that spatially close node
    pairs get a *lower* effective distance during top-k selection. fp32 past
    the sin-cos stage, like upstream's fp32 interpolate.

    The flagship's two (10752, *) tables take seconds each on one host core,
    so results are memoized in-process (encoder and decoder stages share
    identical tables). The cached array is shared: callers copy it. The
    builds' nanoseconds add to the counter ``setup.tables_ns`` (``trace.py``).

    Returns float32 ``(n, n_reduced)``.
    """
    t0 = time.perf_counter_ns()
    if spatial_dims == 2:
        grid = int(n ** (1.0 / 2.0))
        rel = get_2d_relative_pos_embed(channels, grid).astype(np.float32)
    elif spatial_dims == 3:
        grid = int(n ** (1.0 / 3.0))
        rel = get_3d_relative_pos_embed(channels, grid).astype(np.float32)
    else:
        raise ValueError(f"spatial_dims must be 2 or 3, got {spatial_dims}")
    rel = bicubic_resize_2d(rel, (n, n_reduced), dtype=np.float32)
    rel = (-rel).astype(np.float32)
    count("setup.tables_ns", time.perf_counter_ns() - t0)
    return rel
