"""Optimizer and LR schedule: SGD(momentum 0.99, Nesterov) + PolyLR,
counterpart of ``nextou_tpu/train/optimizer.py`` (an optax chain there).

Matches the nnU-Net v2 substrate NexToU trains with: initial LR 1e-2, weight
decay 3e-5 (coupled, torch-SGD style: added to the gradient before the
momentum update), gradient clipping at global norm 12 *before* the decay,
``lr(e) = lr0 * (1 - e/E)^0.9`` stepped per epoch.

The clip is written out as optax does it (``g * max_norm / norm`` when the
norm is not below ``max_norm``): ``torch.nn.utils.clip_grad_norm_`` divides
by ``norm + 1e-6`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

Schedule = Callable[[int], float]


def poly_lr(
    initial_lr: float = 1e-2,
    max_steps: int = 1000,
    exponent: float = 0.9,
    steps_per_epoch: int = 1,
) -> Schedule:
    """PolyLR keyed on epoch (= step // steps_per_epoch), like nnU-Net."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        # clamp at 0: training past max_steps must not produce a negative
        # base (a fractional power of a negative number is NaN)
        frac = max(1.0 - epoch / max_steps, 0.0)
        return initial_lr * frac**exponent

    return schedule


@dataclasses.dataclass(frozen=True)
class SGD:
    """Stateless update rule; the momentum buffers and the step count live in
    the train state."""

    learning_rate: float | Schedule = 1e-2
    momentum: float = 0.99
    nesterov: bool = True
    weight_decay: float = 3e-5
    clip_norm: float | None = 12.0

    def init(self, params: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        return [torch.zeros_like(p) for p in params]

    def lr(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step) if callable(lr) else lr)

    @torch.no_grad()
    def update(
        self,
        grads: Sequence[torch.Tensor],
        momentum: Sequence[torch.Tensor],
        params: Sequence[torch.Tensor],
        step: int,
    ) -> torch.Tensor:
        """One update in place on ``params`` and ``momentum`` (``grads`` is
        consumed: it is overwritten). ``step`` is the number of updates made
        before this one. Returns the global gradient norm before clipping."""
        grads, momentum, params = list(grads), list(momentum), list(params)
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)).to(torch.float32)
        )
        if self.clip_norm is not None and self.clip_norm > 0:
            scale = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        if self.weight_decay:
            torch._foreach_add_(grads, params, alpha=self.weight_decay)
        # trace: m = g + decay * m; the update is g + decay * m with Nesterov
        torch._foreach_mul_(momentum, self.momentum)
        torch._foreach_add_(momentum, grads)
        if self.nesterov:
            torch._foreach_add_(grads, momentum, alpha=self.momentum)
            updates = grads
        else:
            updates = momentum
        torch._foreach_add_(params, updates, alpha=-self.lr(step))
        return norm


def make_optimizer(
    learning_rate: float | Schedule = 1e-2,
    *,
    momentum: float = 0.99,
    nesterov: bool = True,
    weight_decay: float = 3e-5,
    clip_norm: float | None = 12.0,
) -> SGD:
    return SGD(learning_rate, momentum, nesterov, weight_decay, clip_norm)
