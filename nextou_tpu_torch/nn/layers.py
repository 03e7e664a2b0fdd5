"""Basic layers: activations, channels-last norms, 1x1 (grouped) convs.

Counterparts of the live defaults of ``nextou_tpu/nn/layers.py``. The
graph modules work on channels-last tensors ``(B, *spatial, C)`` or nodes
``(B, N, C)``, so their 1x1 convs are matmuls over the channel axis and
their norms normalize the last axis. Parameters keep upstream's conv shapes
and names (``weight (O, I/groups, *1s)``, ``bias``, BatchNorm's running
statistics), so upstream state_dicts load as they are.

Parameters stay f32. Every layer computes in its input's dtype (the model's
compute dtype) and casts its weights to it, so gradients arrive in f32 on
the f32 parameters; norm statistics are f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from nextou_tpu_torch.parallel.distributed import rank, sum_over_ranks, world_size

# He-init gain of upstream's InitWeights_He(neg_slope=1e-2)
HE_GAIN_SQ = 2.0 / (1.0 + 1e-2 ** 2)
LEAKY_SLOPE = 1e-2


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    """Activation by name (upstream ``torch_nn.py:13-29``). 'prelu' is
    parametric and lives in :class:`PReLU` / :class:`ActLayer` only."""
    name = name.lower()
    if name == "relu":
        return F.relu(x)
    if name == "leakyrelu":
        return F.leaky_relu(x, LEAKY_SLOPE)
    if name == "gelu":
        return F.gelu(x)
    if name == "hswish":
        return F.hardswish(x)
    if name == "prelu":
        raise NotImplementedError("prelu is parametric: use ActLayer/PReLU (module form)")
    raise NotImplementedError(f"activation [{name}] is not found")


class Act(nn.Module):
    """Module form of :func:`act` (holds no parameters)."""

    def __init__(self, name: str):
        super().__init__()
        self.name = name

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return act(self.name, x)


class PReLU(nn.Module):
    """Parametric ReLU with ``torch.nn.PReLU(num_parameters, init)``
    semantics (upstream ``torch_nn.py:21-22``): ``max(0, x) + weight *
    min(0, x)``, ``weight`` (f32, ``num_parameters`` entries) broadcast over
    the channel axis, which is the last one here (channels-last nodes).
    ``init`` is the slope it starts at; ``utils/init.py`` keeps it."""

    def __init__(self, num_parameters: int = 1, init: float = LEAKY_SLOPE, device=None):
        super().__init__()
        self.init = init
        self.weight = nn.Parameter(torch.full((num_parameters,), init, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.numel() > 1 and x.shape[-1] != self.weight.numel():
            raise ValueError(f"PReLU of {self.weight.numel()} slopes on {x.shape[-1]} channels")
        a = self.weight.to(x.dtype)
        return torch.clamp_min(x, 0) + a * torch.clamp_max(x, 0)


def ActLayer(name: str, neg_slope: float = LEAKY_SLOPE, n_prelu: int = 1, device=None) -> nn.Module:
    """Module-form activation (upstream ``act_layer``, ``torch_nn.py:13-29``):
    :class:`PReLU` for 'prelu', else :class:`Act`."""
    if name.lower() == "prelu":
        return PReLU(n_prelu, neg_slope, device=device)
    return Act(name)


class PointwiseConv(nn.Module):
    """A 1x1 conv over the last axis: ``(..., cin) -> (..., cout)``.

    ``weight`` has upstream's conv shape ``(cout, cin/groups, *[1]*dims)``.
    With ``groups > 1`` (upstream ``BasicConv``: 4 in 2D, 6 in 3D) the groups
    are scattered into one block-diagonal ``(cout, cin)`` matrix and applied
    as a single matmul: the same result as a grouped conv.
    """

    def __init__(
        self, cin: int, cout: int, dims: int, *, groups: int = 1,
        bias: bool = True, device=None,
    ):
        super().__init__()
        if cin % groups or cout % groups:
            raise ValueError(f"channels {cin}->{cout} not divisible by groups={groups}")
        self.groups = groups
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, *([1] * dims), device=device)
        )
        nn.init.kaiming_normal_(self.weight, a=LEAKY_SLOPE)
        self.bias = (
            nn.Parameter(torch.zeros(cout, device=device)) if bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], -1).to(x.dtype)
        if self.groups > 1:
            w = torch.block_diag(*w.chunk(self.groups, dim=0))
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, w, b)


def batch_norm(module: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Apply a ``BatchNorm{1,2,3}d`` module's parameters to a channels-first
    ``x``: running statistics at eval, batch statistics in training.

    In training the running variance is updated with the *biased* batch
    variance, as flax ``nn.BatchNorm`` (and so ``nextou_tpu``) stores it;
    ``torch.nn.BatchNorm*`` stores the unbiased one. The fused op does the
    update, and its ``n / (n - 1)`` factor is then taken out of the new term.
    ``module.momentum == 0`` leaves both statistics exactly as they are.
    Under data parallel (more than one rank) the batch statistics are the
    global batch's (:func:`_batch_norm_over_ranks`).
    """
    if not module.training:
        return F.batch_norm(
            x, module.running_mean, module.running_var, module.weight,
            module.bias, False, 0.0, module.eps,
        )
    if world_size() > 1:
        return _batch_norm_over_ranks(module, x)
    n = x.numel() // x.shape[1]
    # the fused op updates a copy: autograd keeps the tensor it was given,
    # which must not change before the backward pass
    new_var = module.running_var.clone()
    y = F.batch_norm(
        x, module.running_mean, new_var, module.weight, module.bias, True,
        module.momentum, module.eps,
    )
    with torch.no_grad():
        kept = (1.0 - module.momentum) * module.running_var
        module.running_var.copy_((new_var - kept) * ((n - 1) / n) + kept)
    return y


def _batch_norm_over_ranks(module: nn.modules.batchnorm._BatchNorm,
                           x: torch.Tensor) -> torch.Tensor:
    """Training-mode BatchNorm whose statistics are those of the global
    batch, every rank holding a share of it: the per-channel sums and counts
    summed over the ranks give the mean, then the sums of ``(x - mean)^2``
    the biased variance (two passes, in f32). The running statistics follow
    :func:`batch_norm`'s rule and are equal on every rank. Both all-reduces
    are differentiable, so the gradient reaches every rank's share."""
    dims = [0, *range(2, x.dim())]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    xf = x.float()
    total, count = sum_over_ranks(xf.sum(dims), x.numel() // x.shape[1])
    mean = total / count
    centred = xf - mean.reshape(shape)
    (squares,) = sum_over_ranks(centred.square().sum(dims))
    var = squares / count
    y = centred * torch.rsqrt(var + module.eps).reshape(shape)
    y = y * module.weight.reshape(shape) + module.bias.reshape(shape)
    if module.momentum:
        with torch.no_grad():
            m = module.momentum
            module.running_mean.copy_((1.0 - m) * module.running_mean + m * mean)
            module.running_var.copy_((1.0 - m) * module.running_var + m * var)
    return y.to(x.dtype)


class LastDimBatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of a channels-last tensor (eps 1e-5,
    momentum 0.1; see :func:`batch_norm`). Statistics are f32; the output
    keeps the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(self, x.reshape(-1, x.shape[-1])).reshape(x.shape)


class InstanceNorm(nn.Module):
    """Affine instance norm of a channels-last tensor: per sample and
    channel over every spatial position (nodes), eps 1e-5, f32 statistics
    (upstream ``InstanceNorm{2,3}d(affine=True)``)."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.dim() - 1))
        xf = x.float()
        mean = xf.mean(axes, keepdim=True)
        var = torch.square(xf - mean).mean(axes, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm ``DropPath``): in training each
    sample is dropped with probability ``rate`` and the kept ones are scaled
    by ``1 / (1 - rate)``; the identity at eval or with ``rate == 0``. The
    mask is drawn from ``generator`` (a CPU generator: a seed gives the same
    mask on any device). Under data parallel every rank draws the global
    batch's mask from the same generator state and keeps its own rows, so
    that the ranks draw what one process of the global batch draws."""

    def __init__(self, rate: float, generator: torch.Generator | None):
        super().__init__()
        self.rate = rate
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate <= 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        n, r = x.shape[0], rank()
        mask = torch.rand(n * world_size(), generator=self.generator)[r * n:(r + 1) * n] < keep
        mask = mask.to(x.device).reshape(-1, *([1] * (x.dim() - 1)))
        return torch.where(mask, x / keep, torch.zeros_like(x))


def make_norm(kind: str, channels: int, device=None) -> nn.Module:
    """Channels-last norm by kind ('batch' | 'instance')."""
    kind = kind.lower()
    if kind == "batch":
        return LastDimBatchNorm(channels, eps=1e-5, device=device)
    if kind == "instance":
        return InstanceNorm(channels, device=device)
    raise NotImplementedError(f"normalization layer [{kind}] is not found")


class GroupedMLP(nn.Sequential):
    """Upstream ``BasicConv([cin, cout])`` on channels-last nodes: grouped 1x1
    conv, norm, activation, named ``0``, ``1``, ``2`` like upstream."""

    def __init__(
        self, cin: int, cout: int, dims: int, *, groups: int, norm: str,
        act_name: str, bias: bool = True, device=None,
    ):
        super().__init__(
            PointwiseConv(cin, cout, dims, groups=groups, bias=bias, device=device),
            make_norm(norm, cout, device=device),
            ActLayer(act_name, device=device),
        )
