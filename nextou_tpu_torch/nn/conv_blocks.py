"""Plain conv blocks: upstream ``StackedConvBlocks`` with conv -> BatchNorm ->
LeakyReLU, counterpart of ``nextou_tpu/nn/conv_blocks.py``.

Channels-first ``(B, C, *spatial)``, the layout cuDNN wants. Padding is the
explicit symmetric ``(k-1)//2`` torch uses, never "same" (which would pad a
k=3/stride-2 conv (0, 1) and shift the sampling grid). The residual blocks
are not on the flagship and are not ported yet.

``conv_kernel`` switches the hand-written conv kernel (``kernels/conv.py``)
on, the counterpart of the JAX package's ``NEXTOU_PALLAS_CONV`` as an
explicit argument: ``"0"`` (the default) leaves every conv to the library,
``"1"`` hands the kernel the convs of its region
(:func:`~nextou_tpu_torch.kernels.conv.conv_kernel_wins`), ``"s1"`` only
those with every stride 1, ``"s2"`` only the strided ones.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from nextou_tpu_torch.kernels.conv import conv3d, conv_kernel_wins
from nextou_tpu_torch.nn.layers import LEAKY_SLOPE, batch_norm

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_BATCH_NORM = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}
_CONV_FN = {2: F.conv2d, 3: F.conv3d}
CONV_KERNEL_MODES = ("0", "1", "s1", "s2")


def check_conv_kernel(mode: str) -> str:
    if mode not in CONV_KERNEL_MODES:
        raise ValueError(f"conv_kernel must be one of {CONV_KERNEL_MODES}; got {mode!r}")
    return mode


def takes_conv_kernel(x: torch.Tensor, module: nn.Module, mode: str) -> bool:
    """Whether ``conv`` hands this conv to the kernel: a 3D (3, 3, 3) conv
    with padding (1, 1, 1) that ``mode`` names and that lies in the kernel's
    region (the conditions of the JAX package's dispatch)."""
    if mode == "0" or x.dim() != 5:
        return False
    if tuple(module.kernel_size) != (3, 3, 3) or tuple(module.padding) != (1, 1, 1):
        return False
    strided = any(s > 1 for s in module.stride)
    if (mode == "s1" and strided) or (mode == "s2" and not strided):
        return False
    return conv_kernel_wins(
        x.shape[2:], module.in_channels, module.out_channels, module.kernel_size, module.stride
    )


def conv(x: torch.Tensor, module: nn.Module, conv_kernel: str = "0") -> torch.Tensor:
    """Apply a ``Conv{2,3}d`` module's parameters in ``x``'s dtype, through
    the conv kernel where ``conv_kernel`` says so; the bias is then added
    after it, in ``x``'s dtype."""
    w = module.weight.to(x.dtype)
    b = None if module.bias is None else module.bias.to(x.dtype)
    if takes_conv_kernel(x, module, conv_kernel):
        y = conv3d(x, w, module.stride)
        return y if b is None else y + b.view(1, -1, 1, 1, 1)
    return _CONV_FN[x.dim() - 2](x, w, b, module.stride, module.padding)


class ConvNormAct(nn.Module):
    """conv -> BatchNorm (eps 1e-5, see ``layers.batch_norm``) ->
    LeakyReLU(0.01); upstream names ``conv`` and ``norm``."""

    def __init__(
        self, cin: int, cout: int, kernel_size: Sequence[int],
        stride: Sequence[int], *, bias: bool = True, conv_kernel: str = "0", device=None,
    ):
        super().__init__()
        self.conv_kernel = check_conv_kernel(conv_kernel)
        dims = len(kernel_size)
        self.conv = _CONV[dims](
            cin, cout, tuple(kernel_size), tuple(stride),
            padding=tuple((k - 1) // 2 for k in kernel_size),
            bias=bias, device=device,
        )
        self.norm = _BATCH_NORM[dims](cout, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(batch_norm(self.norm, conv(x, self.conv, self.conv_kernel)), LEAKY_SLOPE)


class StackedConvBlocks(nn.Module):
    """``n`` ConvNormAct blocks under ``convs``; only the first is strided."""

    def __init__(
        self, n: int, cin: int, cout: int, kernel_size: Sequence[int],
        first_stride: Sequence[int], *, bias: bool = True, conv_kernel: str = "0", device=None,
    ):
        super().__init__()
        ones = (1,) * len(kernel_size)
        self.convs = nn.Sequential(*[
            ConvNormAct(
                cin if i == 0 else cout, cout, kernel_size,
                first_stride if i == 0 else ones, bias=bias, conv_kernel=conv_kernel,
                device=device,
            )
            for i in range(n)
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.convs(x)
