"""Deep supervision: weighting and target downsampling, counterpart of
``nextou_tpu/losses/deep_supervision.py``.

Weights follow the upstream trainers: ``w_i = 1/2^i``, the lowest-resolution
output gets weight 0, then normalized to sum 1. Targets are downsampled by
nearest-neighbour (strided slicing, identical to torch 'nearest' for integer
factors).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch


def deep_supervision_weights(n_outputs: int) -> np.ndarray:
    if n_outputs == 1:
        # deep supervision disabled (one full-res output): zeroing the last
        # weight would be 0/0
        return np.array([1.0])
    w = np.array([1.0 / 2**i for i in range(n_outputs)])
    w[-1] = 0.0
    return w / w.sum()


def downsample_target(target: torch.Tensor, out_spatial: Sequence[int]) -> torch.Tensor:
    """``(B, *sp)`` int -> ``(B, *out_spatial)`` by strided nearest sampling."""
    sp = tuple(target.shape[1:])
    if sp == tuple(out_spatial):
        return target
    idx = [slice(None)]
    for s, o in zip(sp, out_spatial):
        if s % o:
            raise ValueError(f"target {sp} is no multiple of output {tuple(out_spatial)}")
        idx.append(slice(None, None, s // o))
    return target[tuple(idx)]


def deep_supervised_loss(
    outputs: Sequence[torch.Tensor],
    target: torch.Tensor,
    loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    weights: Sequence[float] | None = None,
) -> torch.Tensor:
    """Weighted sum of ``loss_fn`` over the deep-supervision outputs
    ``[(B, *sp_i, C), ...]``. Zero-weight entries are skipped entirely."""
    if weights is None:
        weights = deep_supervision_weights(len(outputs))
    total = torch.zeros((), dtype=torch.float32, device=outputs[0].device)
    for w, out in zip(weights, outputs):
        if float(w) == 0.0:
            continue
        total = total + float(w) * loss_fn(out, downsample_target(target, out.shape[1:-1]))
    return total
