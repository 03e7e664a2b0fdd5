"""Plain conv blocks: upstream ``StackedConvBlocks`` with conv -> BatchNorm ->
LeakyReLU, counterpart of ``nextou_tpu/nn/conv_blocks.py``.

Channels-first ``(B, C, *spatial)``, the layout cuDNN wants. Padding is the
explicit symmetric ``(k-1)//2`` torch uses, never "same" (which would pad a
k=3/stride-2 conv (0, 1) and shift the sampling grid). The residual blocks
are not on the flagship and are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nextou_tpu_torch.nn.layers import LEAKY_SLOPE, batch_norm

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_BATCH_NORM = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}
_CONV_FN = {2: F.conv2d, 3: F.conv3d}


def conv(x: torch.Tensor, module: nn.Module) -> torch.Tensor:
    """Apply a ``Conv{2,3}d`` module's parameters in ``x``'s dtype."""
    w = module.weight.to(x.dtype)
    b = None if module.bias is None else module.bias.to(x.dtype)
    return _CONV_FN[x.dim() - 2](x, w, b, module.stride, module.padding)


class ConvNormAct(nn.Module):
    """conv -> BatchNorm (eps 1e-5, see ``layers.batch_norm``) ->
    LeakyReLU(0.01); upstream names ``conv`` and ``norm``."""

    def __init__(
        self, cin: int, cout: int, kernel_size: Sequence[int],
        stride: Sequence[int], *, bias: bool = True, device=None,
    ):
        super().__init__()
        dims = len(kernel_size)
        self.conv = _CONV[dims](
            cin, cout, tuple(kernel_size), tuple(stride),
            padding=tuple((k - 1) // 2 for k in kernel_size),
            bias=bias, device=device,
        )
        self.norm = _BATCH_NORM[dims](cout, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(batch_norm(self.norm, conv(x, self.conv)), LEAKY_SLOPE)


class StackedConvBlocks(nn.Module):
    """``n`` ConvNormAct blocks under ``convs``; only the first is strided."""

    def __init__(
        self, n: int, cin: int, cout: int, kernel_size: Sequence[int],
        first_stride: Sequence[int], *, bias: bool = True, device=None,
    ):
        super().__init__()
        ones = (1,) * len(kernel_size)
        self.convs = nn.Sequential(*[
            ConvNormAct(
                cin if i == 0 else cout, cout, kernel_size,
                first_stride if i == 0 else ones, bias=bias, device=device,
            )
            for i in range(n)
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)
