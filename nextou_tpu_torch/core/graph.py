"""Dense kNN graph primitives (plain PyTorch), counterpart of
``nextou_tpu/core/graph.py``.

Node features are channels-last ``(B, N, C)``. The selection rules are the
JAX package's:

- L2 normalization clamps inside the sqrt (``F.normalize`` semantics, and a
  zero gradient rather than NaN for an all-zero vector);
- square-sums and the inner product are f32 even for bf16 coordinates: the
  coordinates are upcast before the product, because ``torch.matmul`` on
  bf16 tensors rounds its output to bf16 where the JAX code asks for an f32
  result;
- ties go to the lowest index. ``torch.topk`` promises no tie order, so the
  k nearest are taken from a stable sort on distance.

The stochastic dilated branch is training-only and is not ported yet.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize the last axis: ``x / sqrt(max(sum(x^2), eps^2))``."""
    sq = torch.sum(x * x, dim=-1, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def xy_pairwise_sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``(B, N, C)``, ``(B, M, C)`` -> ``(B, N, M)`` squared L2 distances,
    ``(x_sq - 2 x.y) + y_sq``, all in f32."""
    xf, yf = x.float(), y.float()
    x_sq = torch.sum(xf * xf, dim=-1, keepdim=True)  # (B, N, 1)
    y_sq = torch.sum(yf * yf, dim=-1, keepdim=True)  # (B, M, 1)
    inner = torch.bmm(xf, yf.transpose(1, 2))
    return x_sq - 2.0 * inner + y_sq.transpose(1, 2)


def knn_sq_dist(
    x: torch.Tensor,
    y: torch.Tensor | None = None,
    relative_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """The (biased) distances that :func:`dense_knn` selects on, ``(B, N, M)``
    f32. ``relative_pos`` is an ``(N, M)`` or ``(B, N, M)`` additive bias."""
    dist = xy_pairwise_sq_dist(x, x if y is None else y)
    if relative_pos is not None:
        dist = dist + relative_pos.float()
    return dist


def dense_knn(
    x: torch.Tensor,
    k: int,
    y: torch.Tensor | None = None,
    relative_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """Indices ``(B, N, k)`` (int64) of the k nearest candidates of each
    query, by (distance, index): ties go to the lowest index. The features
    are expected to be normalized already."""
    with torch.no_grad():
        dist = knn_sq_dist(x, y, relative_pos)
        return torch.sort(dist, dim=-1, stable=True).indices[..., :k]


def batched_index_select(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (B, M, C)``, ``idx (B, N, k)`` -> ``(B, N, k, C)`` gathered rows."""
    B, N, k = idx.shape
    flat = idx.reshape(B, N * k, 1).expand(B, N * k, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(B, N, k, x.shape[-1])
