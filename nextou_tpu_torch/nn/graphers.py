"""Grapher blocks: FFN, SwinGrapher (windowed local GNN), PoolGrapher
(global pooled GNN), counterpart of ``nextou_tpu/nn/graphers.py`` (upstream
``NexToU_Encoder_Decoder.py:368-390,695-933``).

All three take and return channels-last maps ``(B, *spatial, C)``. Their
fc1/fc2 are 1x1 convs (matmuls on the channel axis) + BatchNorm. Each
grapher holds its fixed relative-position kNN bias as the buffer
``relative_pos`` ``(1, N, N_reduced)``, upstream's name and shape; the model
builds each table once and hands the same tensor to every grapher that
uses it.

``drop_path`` is the stochastic-depth rate of the block's residual branch
(0 in every shipped spec); its mask and the stochastic dilated graph draw
from the ``generator`` the model hands down.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from nextou_tpu_torch.core.window import window_partition, window_reverse
from nextou_tpu_torch.nn.graph_conv import DyGraphConv, PoolDyGraphConv
from nextou_tpu_torch.nn.layers import DropPath, LastDimBatchNorm, PointwiseConv, act


class Fc(nn.Sequential):
    """Upstream's ``fc1``/``fc2``: 1x1 conv (``0``) + BatchNorm (``1``)."""

    def __init__(self, cin: int, cout: int, dims: int, device=None):
        super().__init__(
            PointwiseConv(cin, cout, dims, device=device),
            LastDimBatchNorm(cout, eps=1e-5, device=device),
        )


class FFN(nn.Module):
    """``x + fc2(act(fc1(x)))`` (upstream ``:368-390``)."""

    def __init__(self, channels: int, hidden: int, dims: int, *, act_name: str,
                 drop_path: float = 0.0, generator=None, device=None):
        super().__init__()
        self.act_name = act_name
        self.fc1 = Fc(channels, hidden, dims, device)
        self.fc2 = Fc(hidden, channels, dims, device)
        self.drop_path = DropPath(drop_path, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop_path(self.fc2(act(self.act_name, self.fc1(x)))) + x


class SwinGrapher(nn.Module):
    """Windowed local GNN: roll by -shift, window partition, fc1, kNN graph
    conv inside each window, fc2, window reverse, roll back, residual. The
    shift is applied in every block, and the graph conv's norm is batch
    whatever the spec says (upstream hard-codes it, ``:714``)."""

    def __init__(
        self, channels: int, relative_pos: torch.Tensor, *,
        window_size: Sequence[int], shift_size: Sequence[int], k: int,
        groups: int, act_name: str, bias: bool = True, drop_path: float = 0.0,
        generator=None, device=None, **graph,
    ):
        super().__init__()
        dims = len(window_size)
        self.window_size = tuple(window_size)
        self.shift_size = tuple(shift_size)
        n = math.prod(window_size)
        assert relative_pos.shape == (1, n, n), relative_pos.shape
        self.fc1 = Fc(channels, channels, dims, device)
        self.graph_conv = DyGraphConv(
            channels, 2 * channels, dims, k=k, groups=groups, norm="batch",
            act_name=act_name, bias=bias, generator=generator, device=device,
            **graph,
        )
        self.fc2 = Fc(2 * channels, channels, dims, device)
        self.drop_path = DropPath(drop_path, generator)
        self.register_buffer("relative_pos", relative_pos)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sp = x.shape[1:-1]
        axes = tuple(range(1, 1 + len(sp)))
        shifted = max(self.shift_size) > 0
        h = torch.roll(x, [-s for s in self.shift_size], axes) if shifted else x
        h = self.fc1(window_partition(h, self.window_size))
        h = self.fc2(self.graph_conv(h, self.relative_pos[0]))
        h = window_reverse(h, self.window_size, sp)
        if shifted:
            h = torch.roll(h, list(self.shift_size), axes)
        return self.drop_path(h) + x


class PoolGrapher(nn.Module):
    """Global pooled GNN: fc1, PoolDyGraphConv over the whole map, fc2,
    residual. The graph conv's norm is the spec's ``gnn_norm``."""

    def __init__(
        self, channels: int, relative_pos: torch.Tensor, *,
        pool_size: Sequence[int], k: int, reduce_ratio: int, groups: int,
        act_name: str, norm: str, bias: bool = True, drop_path: float = 0.0,
        generator=None, device=None, **graph,
    ):
        super().__init__()
        dims = len(pool_size)
        self.fc1 = Fc(channels, channels, dims, device)
        self.graph_conv = PoolDyGraphConv(
            channels, 2 * channels, dims, pool_size=pool_size, k=k,
            reduce_ratio=reduce_ratio, groups=groups, norm=norm,
            act_name=act_name, bias=bias, generator=generator, device=device,
            **graph,
        )
        self.fc2 = Fc(2 * channels, channels, dims, device)
        self.drop_path = DropPath(drop_path, generator)
        self.register_buffer("relative_pos", relative_pos)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc2(self.graph_conv(self.fc1(x), self.relative_pos[0]))
        return self.drop_path(h) + x
