"""nnU-Net's optimizer, plainly: SGD with momentum 0.99 and Nesterov, weight
decay 3e-5 added to the gradient, the gradient clipped to global norm 12
first (``g * 12 / norm`` where the norm is not below 12), PolyLR from 1e-2
by epoch (1000 epochs of 250 steps)."""

from __future__ import annotations

import torch


def poly_lr(step: int, lr0=1e-2, epochs=1000, steps_per_epoch=250, exponent=0.9) -> float:
    return lr0 * max(1.0 - (step // steps_per_epoch) / epochs, 0.0) ** exponent


@torch.no_grad()
def sgd_step(params, grads, momentum, step, clip=12.0, decay=3e-5, mu=0.99):
    """Updates ``params`` and ``momentum`` in place; returns the clipped
    gradients as the update rule received them."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
    scale = 1.0 if norm < clip else clip / norm
    clipped = [g * scale for g in grads]
    lr = poly_lr(step)
    for p, g, m in zip(params, clipped, momentum):
        d = g + decay * p
        m.mul_(mu).add_(d)
        p.sub_(lr * (d + mu * m))
    return clipped
