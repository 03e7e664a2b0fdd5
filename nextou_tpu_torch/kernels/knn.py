"""kNN + neighbour-max: the dispatcher, the four hand-written kernels and
their plain versions.

The hot op of every grapher: L2-normalize the node features, squared
distances (+ relative-position bias), k nearest by (distance, index), and
the per-channel max over those k rows of the raw values. MRConv needs only
that max, since ``max_j (x_j - x_i) = (max_j x_j) - x_i``.

Kernels (CUDA C++ under ``nextou_tpu_torch/csrc/``, built with ``nvcc`` at
first use, one library per source, by ``kernels/build.py``) and, beside
each, its plain PyTorch version:

- K1 :func:`knn_max_cuda` (``knn_max.cu``): the fused inference forward;
  plain version :func:`knn_max_neighbors_reference`.
- K2 :func:`knn_indices_cuda` (``knn_max_idx.cu``): the selection alone;
  :func:`knn_indices_reference`.
- K3 :func:`knn_max_idx_cuda` (``knn_max_idx.cu``): the training forward,
  max and indices; :func:`knn_max_idx_reference`.
- K4 :func:`knn_max_bwd_cuda` (``knn_max_bwd.cu``): the backward with
  respect to the candidate values, deterministic;
  :func:`knn_max_bwd_reference`.

:class:`KnnMaxTrain` joins K3 and K4 into one differentiable op.
:func:`knn_max_neighbors` dispatches on the tensor's device: a CPU tensor
goes to the plain version (autograd differentiates it by itself), a CUDA
tensor to K1, or to K3/K4 when a gradient is needed, or raises. There is no
fallback from a kernel to a plain version. Each wrapper counts its launches
in ``.launches``.
"""

from __future__ import annotations

import torch

from nextou_tpu_torch.core.graph import (
    batched_index_select,
    dense_knn_reference,
    l2_normalize,
)
from nextou_tpu_torch.kernels.build import check_tensors as _check
from nextou_tpu_torch.kernels.build import library
from nextou_tpu_torch.kernels.build import ptr as _ptr

K_MAX = 32  # the kernels keep the running top-k in one warp's lanes


# --- plain versions ---------------------------------------------------------------


def coord_dtype(dtype: torch.dtype, train: bool = False) -> torch.dtype:
    """Dtype the normalized coordinates are selected in: f32 in a training
    step; else bf16 for a bf16 model and f32 for anything else
    (``_coord_dtype`` in the JAX package)."""
    if train:
        return torch.float32
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _normalized(x, y, train: bool = False):
    cdt = coord_dtype(x.dtype, train)
    xn = l2_normalize(x.float()).to(cdt)
    yn = xn if y is None or y is x else l2_normalize(y.float()).to(cdt)
    return xn, yn


def knn_max_neighbors_reference(
    x: torch.Tensor,
    k: int,
    y: torch.Tensor | None = None,
    relative_pos: torch.Tensor | None = None,
    train: bool = False,
) -> torch.Tensor:
    """Plain version: normalize, distances, stable-sort top-k, gather, max.

    Returns ``(B, N, C)`` in the value dtype (``y``'s, else ``x``'s), like
    the JAX reference helper. Differentiable with respect to the values; the
    selection carries no gradient.
    """
    xn, yn = _normalized(x, y, train)
    idx = dense_knn_reference(xn, k, yn, relative_pos)
    vals = x if y is None else y
    return torch.amax(batched_index_select(vals, idx), dim=2)


def knn_indices_reference(
    xn: torch.Tensor, yn: torch.Tensor, rel: torch.Tensor | None, k: int
) -> torch.Tensor:
    """Plain version of K2: ``(B, N, k)`` int32, nearest first, ties to the
    lowest index, on coordinates that are normalized already."""
    return dense_knn_reference(xn, k, yn, rel).to(torch.int32)


def knn_max_idx_reference(
    xn: torch.Tensor, yn: torch.Tensor, yv: torch.Tensor,
    rel: torch.Tensor | None, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: the f32 per-channel max over the selected rows of
    ``yv`` and the ``(B, N, k)`` int32 selection."""
    idx = dense_knn_reference(xn, k, yn, rel)
    maxv = torch.amax(batched_index_select(yv, idx), dim=2).float()
    return maxv, idx.to(torch.int32)


def knn_max_bwd_reference(
    yv: torch.Tensor, idx: torch.Tensor, maxv: torch.Tensor, g: torch.Tensor, k: int
) -> torch.Tensor:
    """Plain version of K4: gather, compare with the max, count the ties,
    ``index_add_`` of ``eq * g / cnt``. Returns ``(B, M, C)`` f32."""
    B, M, C = yv.shape
    N = idx.shape[1]
    sel = batched_index_select(yv.float(), idx.long())  # (B, N, k, C)
    eq = (sel == maxv[:, :, None, :]).float()
    share = g.float() / eq.sum(2).clamp(min=1.0)  # (B, N, C)
    contrib = (eq * share[:, :, None, :]).reshape(B * N * k, C)
    rows = (idx.long() + M * torch.arange(B, device=idx.device)[:, None, None]).reshape(-1)
    gy = torch.zeros(B * M, C, dtype=torch.float32, device=yv.device)
    return gy.index_add_(0, rows, contrib).reshape(B, M, C)


# --- kernel wrappers ------------------------------------------------------------


def _check_k(name: str, k: int, M: int):
    if not 1 <= k <= min(K_MAX, M):
        raise ValueError(f"{name}: k={k} outside [1, min({K_MAX}, M={M})]")


def kernel_bias(relative_pos: torch.Tensor | None, k: int, N: int, M: int):
    """What every kernel asks of a caller's bias and ``k``: one bias shared
    by the batch and ``k <= min(32, M)``, else ``NotImplementedError``.
    Returns the bias as the kernels read it: ``(N, M)`` f32, contiguous."""
    if relative_pos is not None and relative_pos.dim() != 2:
        raise NotImplementedError("the kernels take one (N, M) bias shared by the batch")
    if k > min(K_MAX, M):
        raise NotImplementedError(f"the kernels take k <= min({K_MAX}, M); got k={k}, M={M}")
    if relative_pos is None:
        return None
    return relative_pos.detach().to(torch.float32).expand(N, M).contiguous()


_F32 = (torch.float32,)
_VALUES = (torch.bfloat16, torch.float32)


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
    dev = _check(
        "knn_max_cuda", {"xn": xn, "yn": yn, "yv": yv, "rel": rel},
        {"xn": _VALUES, "yn": (xn.dtype,), "yv": (xn.dtype,), "rel": _F32},
        {"xn": (B, N, C), "yn": (B, M, C), "yv": (B, M, C), "rel": (N, M)},
    )
    _check_k("knn_max_cuda", k, M)
    lib = library("knn_max")
    out = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.knn_max_forward(
            _ptr(xn), _ptr(yn), _ptr(yv), _ptr(rel), _ptr(out),
            B, N, M, C, k, int(xn.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"knn_max_cuda: launch failed with CUDA error {rc}")
    knn_max_cuda.launches += 1
    return out


knn_max_cuda.launches = 0


def knn_max_idx_cuda(
    xn: torch.Tensor,
    yn: torch.Tensor,
    yv: torch.Tensor,
    rel: torch.Tensor | None,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on normalized f32 coordinates ``xn (B, N, C)``,
    ``yn (B, M, C)``, raw values ``yv (B, M, C)`` in bf16 or f32, and an
    optional ``(N, M)`` f32 bias. Returns the max ``(B, N, C)`` f32 and the
    selection ``(B, N, k)`` int32, nearest first.

    ``knn_max_idx_cuda.launches`` counts the launches.
    """
    B, N, C = xn.shape
    M = yn.shape[1]
    dev = _check(
        "knn_max_idx_cuda", {"xn": xn, "yn": yn, "yv": yv, "rel": rel},
        {"xn": _F32, "yn": _F32, "yv": _VALUES, "rel": _F32},
        {"xn": (B, N, C), "yn": (B, M, C), "yv": (B, M, C), "rel": (N, M)},
    )
    _check_k("knn_max_idx_cuda", k, M)
    lib = library("knn_max_idx")
    out = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    idx = torch.empty((B, N, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.knn_max_idx_forward(
            _ptr(xn), _ptr(yn), _ptr(yv), _ptr(rel), _ptr(out), _ptr(idx),
            B, N, M, C, k, int(yv.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"knn_max_idx_cuda: launch failed with CUDA error {rc}")
    knn_max_idx_cuda.launches += 1
    return out, idx


knn_max_idx_cuda.launches = 0


def knn_indices_cuda(
    xn: torch.Tensor, yn: torch.Tensor, rel: torch.Tensor | None, k: int
) -> torch.Tensor:
    """Launch K2 on normalized f32 coordinates ``xn (B, N, C)``,
    ``yn (B, M, C)`` and an optional ``(N, M)`` f32 bias. Returns the
    selection ``(B, N, k)`` int32, nearest first.

    ``knn_indices_cuda.launches`` counts the launches.
    """
    B, N, C = xn.shape
    M = yn.shape[1]
    dev = _check(
        "knn_indices_cuda", {"xn": xn, "yn": yn, "rel": rel},
        {"xn": _F32, "yn": _F32, "rel": _F32},
        {"xn": (B, N, C), "yn": (B, M, C), "rel": (N, M)},
    )
    _check_k("knn_indices_cuda", k, M)
    lib = library("knn_max_idx")
    idx = torch.empty((B, N, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.knn_indices_forward(
            _ptr(xn), _ptr(yn), _ptr(rel), _ptr(idx), B, N, M, C, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"knn_indices_cuda: launch failed with CUDA error {rc}")
    knn_indices_cuda.launches += 1
    return idx


knn_indices_cuda.launches = 0


def knn_max_bwd_cuda(
    yv: torch.Tensor, idx: torch.Tensor, maxv: torch.Tensor, g: torch.Tensor, k: int
) -> torch.Tensor:
    """Launch K4: candidate values ``yv (B, M, C)`` in bf16 or f32, the
    forward's selection ``idx (B, N, k)`` int32 (k distinct candidates in
    [0, M) per row), its f32 max ``maxv (B, N, C)`` and the f32 cotangent
    ``g (B, N, C)``. Returns the gradient ``(B, M, C)`` f32. The add order is
    fixed by ``idx``, so two runs give the same bits.

    ``knn_max_bwd_cuda.launches`` counts the launches.
    """
    B, M, C = yv.shape
    N = idx.shape[1]
    dev = _check(
        "knn_max_bwd_cuda", {"yv": yv, "idx": idx, "maxv": maxv, "g": g},
        {"yv": _VALUES, "idx": (torch.int32,), "maxv": _F32, "g": _F32},
        {"yv": (B, M, C), "idx": (B, N, k), "maxv": (B, N, C), "g": (B, N, C)},
    )
    _check_k("knn_max_bwd_cuda", k, M)
    lib = library("knn_max_bwd")
    gy = torch.empty((B, M, C), dtype=torch.float32, device=dev)
    share = torch.empty((B, N, C), dtype=torch.float32, device=dev)
    bitmap = torch.empty((B, M, (N + 31) // 32), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.knn_max_backward(
            _ptr(yv), _ptr(idx), _ptr(maxv), _ptr(g), _ptr(gy), _ptr(share),
            _ptr(bitmap), B, N, M, C, k, int(yv.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"knn_max_bwd_cuda: launch failed with CUDA error {rc}")
    knn_max_bwd_cuda.launches += 1
    return gy


knn_max_bwd_cuda.launches = 0


# --- the differentiable op and the dispatcher ------------------------------------------


class KnnMaxTrain(torch.autograd.Function):
    """K3 forward, K4 backward: the counterpart of ``_knn_max_train2``.

    ``apply(x, y, rel, k, train)`` with ``x (B, N, C)`` the queries and
    ``y (B, M, C)`` the candidates (a self-graph passes ``x`` twice and
    autograd sums the two gradients). The forward saves the values, the
    indices and the f32 max: the JAX package saves the max cast to
    ``x.dtype``, which never equals an f32 value again when x is bf16 and y
    f32, and the gradient is then silently zero. The backward gives the
    queries no gradient (``None``: selection carries none) and the candidates
    K4's output in their dtype.
    """

    @staticmethod
    def forward(ctx, x, y, rel, k, train):
        xn, yn = _normalized(x, y, train)
        # K3 takes f32 coordinates; bf16-rounded ones are exact in f32, and
        # the kernels multiply them as f32 either way
        xn = xn.float().contiguous()
        yn = xn if yn is xn else yn.float().contiguous()
        yv = (y if y.dtype == torch.bfloat16 else y.float()).contiguous()
        maxv, idx = knn_max_idx_cuda(xn, yn, yv, rel, k)
        ctx.save_for_backward(yv, idx, maxv)
        ctx.k, ctx.y_dtype = k, y.dtype
        return maxv.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        yv, idx, maxv = ctx.saved_tensors
        gy = knn_max_bwd_cuda(yv, idx, maxv, g.float().contiguous(), ctx.k)
        return None, gy.to(ctx.y_dtype), None, None, None


def knn_max_neighbors(
    x: torch.Tensor,
    k: int,
    y: torch.Tensor | None = None,
    relative_pos: torch.Tensor | None = None,
    *,
    train: bool = False,
) -> torch.Tensor:
    """Per-channel max over the k nearest neighbours of each node.

    Args:
        x: ``(B, N, C)`` query/node features (raw; normalized here).
        k: neighbours per node.
        y: optional ``(B, M, C)`` candidate set (raw); defaults to ``x``.
        relative_pos: optional ``(N, M)`` additive distance bias.
        train: True inside a training step: select on f32 coordinates.
    Returns:
        ``(B, N, C)`` in ``x.dtype``.

    A CPU tensor goes to the plain version. A CUDA tensor goes to K3/K4
    (:class:`KnnMaxTrain`) when a gradient is needed and to K1 otherwise;
    what the kernels do not take (a per-batch bias, ``k > min(32, M)``)
    raises.
    """
    if x.device.type == "cpu":
        return knn_max_neighbors_reference(x, k, y, relative_pos, train).to(x.dtype)
    if x.device.type != "cuda":
        raise NotImplementedError(f"knn_max_neighbors on {x.device.type}")
    vals = x if y is None else y
    rel = kernel_bias(relative_pos, k, x.shape[1], vals.shape[1])
    if torch.is_grad_enabled() and (x.requires_grad or vals.requires_grad):
        return KnnMaxTrain.apply(x, vals, rel, k, train)
    xn, yn = _normalized(x, y, train)
    # the cast commutes with the max (rounding is monotonic): exact for x and
    # y in bf16 or f32
    yv = vals.to(xn.dtype)
    out = knn_max_cuda(xn.contiguous(), yn.contiguous(), yv.contiguous(), rel, k)
    return out.to(x.dtype)
