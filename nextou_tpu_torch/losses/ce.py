"""Cross-entropy loss (channels-last logits, integer targets), counterpart
of ``nextou_tpu/losses/ce.py``.

Equivalent of nnU-Net's ``RobustCrossEntropyLoss``: mean over the voxels
that are not ignored. Computed in f32 whatever the logits' dtype.
"""

from __future__ import annotations

import torch


def cross_entropy_elementwise(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-voxel CE: logits ``(B, *sp, C)``, target ``(B, *sp)`` int ->
    ``(B, *sp)`` f32. Targets outside ``[0, C)`` are clamped into it (an
    ignore label is masked by the caller)."""
    C = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = target.long().clamp(0, C - 1)
    return -torch.gather(logp, -1, tgt.unsqueeze(-1)).squeeze(-1)


def cross_entropy_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    *,
    ignore_index: int | None = None,
) -> torch.Tensor:
    ce = cross_entropy_elementwise(logits, target)
    if ignore_index is None:
        return ce.mean()
    mask = (target != ignore_index).float()
    return (ce * mask).sum() / mask.sum().clamp(min=1.0)
