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

:func:`dense_knn` dispatches on the device: a CPU tensor goes to the stable
sort (:func:`dense_knn_reference`), a CUDA tensor to the hand-written kernel
K2 (``nextou_tpu_torch.kernels.knn.knn_indices_cuda``) or raises.
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


def dense_knn_reference(
    x: torch.Tensor,
    k: int,
    y: torch.Tensor | None = None,
    relative_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of :func:`dense_knn` on any device: a stable sort on
    distance, so that ties go to the lowest index."""
    with torch.no_grad():
        dist = knn_sq_dist(x, y, relative_pos)
        return torch.sort(dist, dim=-1, stable=True).indices[..., :k]


def dense_knn(
    x: torch.Tensor,
    k: int,
    y: torch.Tensor | None = None,
    relative_pos: torch.Tensor | None = None,
) -> torch.Tensor:
    """Indices ``(B, N, k)`` (int64) of the k nearest candidates of each
    query, by (distance, index), nearest first: ties go to the lowest index.
    The features are expected to be normalized already.

    A CPU tensor goes to the plain version, a CUDA tensor to K2, which takes
    ``k <= min(32, M)`` and one ``(N, M)`` bias shared by the batch, and
    raises on anything else.
    """
    if x.device.type == "cpu":
        return dense_knn_reference(x, k, y, relative_pos)
    if x.device.type != "cuda":
        raise NotImplementedError(f"dense_knn on {x.device.type}")
    from nextou_tpu_torch.kernels.knn import kernel_bias, knn_indices_cuda

    N, M = x.shape[1], (x if y is None else y).shape[1]
    rel = kernel_bias(relative_pos, k, N, M)
    with torch.no_grad():
        xn = x.float().contiguous()
        yn = xn if y is None else y.float().contiguous()
        return knn_indices_cuda(xn, yn, rel, k).long()


def dilated_knn_graph(
    x: torch.Tensor,
    k: int,
    dilation: int = 1,
    y: torch.Tensor | None = None,
    relative_pos: torch.Tensor | None = None,
    *,
    stochastic: bool = False,
    epsilon: float = 0.0,
    generator: torch.Generator | None = None,
    shuffle: bool | None = None,
    perm_cols: torch.Tensor | None = None,
) -> torch.Tensor:
    """L2-normalize the features (in f32 whatever the model dtype), take the
    ``k * dilation`` nearest neighbours, then keep every ``dilation``-th; or,
    with probability ``epsilon`` when ``stochastic`` (training only), a
    random size-``k`` subset of them. Counterpart of ``dilated_knn_graph`` in
    ``nextou_tpu/core/graph.py``.

    One Bernoulli draw gates the whole call, and one permutation serves every
    row, as there. Both come from ``generator`` (a CPU generator, so that a
    seed gives the same draws on any device): first the gate, one uniform
    number, then ``torch.randperm(k * dilation)``. ``shuffle`` and
    ``perm_cols`` (the ``k`` columns to keep) replace the draws when given:
    the JAX package draws other numbers from the same seed, so a test hands
    both packages the same gate and columns. With ``dilation == 1`` the
    branch is skipped: it would permute the full neighbour set, which a max
    over the neighbours does not see.

    Returns ``(B, N, k)`` int64 neighbour indices.
    """
    xn = l2_normalize(x.float())
    yn = None if y is None else l2_normalize(y.float())
    nn_idx = dense_knn(xn, k * dilation, yn, relative_pos)
    if dilation <= 1:
        return nn_idx
    if stochastic and epsilon > 0.0:
        if shuffle is None or perm_cols is None:
            if generator is None:
                raise ValueError("stochastic dilated kNN requires a generator")
            gate = torch.rand((), generator=generator).item() < epsilon
            cols = torch.randperm(k * dilation, generator=generator)[:k]
            shuffle = gate if shuffle is None else shuffle
            perm_cols = cols if perm_cols is None else perm_cols
        if shuffle:
            return nn_idx[..., perm_cols.to(nn_idx.device)]
    return nn_idx[..., ::dilation]


def batched_index_select(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x (B, M, C)``, ``idx (B, N, k)`` -> ``(B, N, k, C)`` gathered rows."""
    B, N, k = idx.shape
    flat = idx.reshape(B, N * k, 1).expand(B, N * k, x.shape[-1])
    return torch.gather(x, 1, flat).reshape(B, N, k, x.shape[-1])
