"""Graph convolution: MRConv, DyGraphConv, PoolDyGraphConv (channels-last).

Counterpart of ``nextou_tpu/nn/graph_conv.py`` (upstream
``NexToU_Encoder_Decoder.py:392-551``):

- :class:`MRConv`: max-relative aggregation with upstream's channel
  interleave ``[x0, m0, x1, m1, ...]``;
- :class:`DyGraphConv`: kNN graph over the map's nodes (candidates
  avg-pooled by ``r``) + MRConv;
- :class:`PoolDyGraphConv`: max pool (argmax kept) before the graph, the
  channel-doubled output scattered back to the argmax positions after.

With dilation 1 (every flagship graph) the per-channel neighbour max comes
from :func:`nextou_tpu_torch.kernels.knn_max_neighbors`: K1 on the card, K3
and K4 when a gradient is needed. A dilated graph sub-samples the indices
before the gather, so a fused max cannot be used: the indices come from
:func:`nextou_tpu_torch.core.graph.dilated_knn_graph` (K2 on the card) and
the gather and max after it are plain PyTorch with autograd.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from nextou_tpu_torch.core.graph import batched_index_select, dilated_knn_graph
from nextou_tpu_torch.kernels.knn import knn_max_neighbors
from nextou_tpu_torch.nn.layers import GroupedMLP


def avg_pool(x: torch.Tensor, r: int) -> torch.Tensor:
    """Channels-last average pool, kernel = stride = r, VALID (floor), summed
    in f32 (``F.avg_pool{2,3}d(x, r, r)`` on the pooled extents)."""
    sp = x.shape[1:-1]
    out = [s // r for s in sp]
    crop = x[(slice(None), *[slice(0, o * r) for o in out])]
    shape = [x.shape[0]]
    for o in out:
        shape += [o, r]
    win = crop.reshape(*shape, x.shape[-1]).float()
    summed = win.sum(dim=tuple(2 + 2 * i for i in range(len(sp))))
    return (summed / float(r ** len(sp))).to(x.dtype)


def _window_split(x: torch.Tensor, pool: Sequence[int]) -> torch.Tensor:
    """(B, *sp, C) -> (B, *sp//pool, prod(pool), C), row-major window scan
    (the order torch's pooling scans a window)."""
    B, C = x.shape[0], x.shape[-1]
    sp = x.shape[1:-1]
    nd = len(pool)
    shape = [B]
    for s, p in zip(sp, pool):
        assert s % p == 0, (sp, pool)
        shape += [s // p, p]
    x = x.reshape(*shape, C)
    perm = (
        [0]
        + [1 + 2 * i for i in range(nd)]
        + [2 + 2 * i for i in range(nd)]
        + [1 + 2 * nd]
    )
    out_sp = [s // p for s, p in zip(sp, pool)]
    return x.permute(perm).reshape(B, *out_sp, math.prod(pool), C)


def _window_merge(x: torch.Tensor, pool: Sequence[int]) -> torch.Tensor:
    """Inverse of :func:`_window_split`: (B, *sp2, P, C) -> (B, *sp, C)."""
    B, C = x.shape[0], x.shape[-1]
    sp2 = x.shape[1:-2]
    nd = len(pool)
    x = x.reshape(B, *sp2, *pool, C)
    perm = [0]
    for i in range(nd):
        perm += [1 + i, 1 + nd + i]
    perm.append(1 + 2 * nd)
    out_sp = [s * p for s, p in zip(sp2, pool)]
    return x.permute(perm).reshape(B, *out_sp, C)


def max_pool_with_argmax(x: torch.Tensor, pool: Sequence[int]):
    """Max pool keeping the per-window argmax (the first max in window-scan
    order, as ``torch.argmax`` documents and torch's MaxPool returns).

    Returns (pooled (B, *sp2, C), argmax int64 (B, *sp2, C) in [0, prod(pool))).
    """
    w = _window_split(x, pool)
    return torch.amax(w, dim=-2), torch.argmax(w, dim=-2)


def max_unpool_scatter(
    values: torch.Tensor, argmax: torch.Tensor, pool: Sequence[int]
) -> torch.Tensor:
    """Scatter ``values (B, *sp2, C)`` back to ``(B, *sp, C)`` at the window
    positions in ``argmax (B, *sp2, Ci)``, zeros elsewhere. ``C`` may be a
    multiple of ``Ci``: the index channels repeat (upstream duplicates its
    indices for the channel-doubled output, ``NexToU_Encoder_Decoder.py:536``)."""
    C, Ci = values.shape[-1], argmax.shape[-1]
    assert C % Ci == 0, (C, Ci)
    if C != Ci:
        argmax = argmax.repeat(*([1] * (argmax.dim() - 1)), C // Ci)
    win = values.new_zeros(*values.shape[:-1], math.prod(pool), C)
    win.scatter_(-2, argmax.unsqueeze(-2), values.unsqueeze(-2))
    return _window_merge(win, pool)


class MRConv(nn.Module):
    """Max-relative graph conv on nodes ``(B, N, C)`` given the per-channel
    max over each node's neighbours: ``max_j (x_j - x_i) = (max_j x_j) - x_i``.
    The MLP is ``nn`` (upstream ``gconv.nn``)."""

    def __init__(
        self, cin: int, cout: int, dims: int, *, groups: int, norm: str,
        act_name: str, bias: bool = True, device=None,
    ):
        super().__init__()
        self.nn = GroupedMLP(
            2 * cin, cout, dims, groups=groups, norm=norm, act_name=act_name,
            bias=bias, device=device,
        )

    def forward(self, x: torch.Tensor, max_neighbors: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        h = torch.stack([x, max_neighbors - x], dim=-1).reshape(B, N, 2 * C)
        return self.nn(h)


class DyGraphConv(nn.Module):
    """Dynamic-graph MRConv over a channels-last map ``(B, *sp, C)``."""

    def __init__(
        self, cin: int, cout: int, dims: int, *, k: int, dilation: int = 1,
        reduce_ratio: int = 1, stochastic: bool = False, epsilon: float = 0.0,
        generator: torch.Generator | None = None, groups: int, norm: str,
        act_name: str, bias: bool = True, device=None,
    ):
        super().__init__()
        self.k = k
        self.dilation = dilation
        self.reduce_ratio = reduce_ratio
        self.stochastic = stochastic
        self.epsilon = epsilon
        self.generator = generator
        self.gconv = MRConv(
            cin, cout, dims, groups=groups, norm=norm, act_name=act_name,
            bias=bias, device=device,
        )

    def aggregate(self, x: torch.Tensor, relative_pos) -> torch.Tensor:
        """kNN graph + MRConv on ``x (B, *sp, C)``; returns (B, N, cout) nodes.

        ``x`` arrives in the model's compute dtype (every layer emits it), the
        dtype the JAX module casts the nodes to before its kNN
        (``graph_conv.py:177-180``): it picks bf16 or f32 coordinates.
        """
        B, C = x.shape[0], x.shape[-1]
        nodes = x.reshape(B, -1, C)
        cand = None
        if self.reduce_ratio > 1:
            cand = avg_pool(x, self.reduce_ratio).reshape(B, -1, C)
        if self.dilation == 1:
            maxy = knn_max_neighbors(
                nodes, self.k, y=cand, relative_pos=relative_pos, train=self.training
            )
        else:
            idx = dilated_knn_graph(
                nodes, self.k, self.dilation, cand, relative_pos,
                stochastic=self.stochastic and self.training,
                epsilon=self.epsilon, generator=self.generator,
            )
            vals = nodes if cand is None else cand
            maxy = torch.amax(batched_index_select(vals, idx), dim=2)
        return self.gconv(nodes, maxy)

    def forward(self, x: torch.Tensor, relative_pos=None) -> torch.Tensor:
        out = self.aggregate(x, relative_pos)
        return out.reshape(*x.shape[:-1], out.shape[-1])


class PoolDyGraphConv(DyGraphConv):
    """DyGraphConv over the max-pooled node set, scattered back after.
    ``pool_size`` comes from the spec (2 per even axis on large maps)."""

    def __init__(self, cin: int, cout: int, dims: int, *, pool_size, **kw):
        super().__init__(cin, cout, dims, **kw)
        self.pool_size = tuple(pool_size)

    def forward(self, x: torch.Tensor, relative_pos=None) -> torch.Tensor:
        pooled, arg = max_pool_with_argmax(x, self.pool_size)
        out = self.aggregate(pooled, relative_pos)
        out = out.reshape(*pooled.shape[:-1], out.shape[-1])
        return max_unpool_scatter(out, arg, self.pool_size)
