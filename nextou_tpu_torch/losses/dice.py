"""Memory-efficient soft Dice loss (channels-last), counterpart of
``nextou_tpu/losses/dice.py``.

Equivalent of nnU-Net's ``MemoryEfficientSoftDiceLoss`` with the settings
the NexToU trainers use (batch_dice per plans, smooth 1e-5, do_bg False).
The all-reduce of the statistics over data-parallel ranks comes with data
parallel training and is not ported yet.
"""

from __future__ import annotations

import torch


def soft_dice_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    *,
    batch_dice: bool = False,
    do_bg: bool = False,
    smooth: float = 1e-5,
    loss_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Soft Dice on softmax probabilities.

    Args:
        logits: ``(B, *spatial, C)`` raw scores.
        target: ``(B, *spatial)`` integer labels.
        loss_mask: optional ``(B, *spatial)`` {0,1} mask (ignore-label support).
    Returns:
        scalar loss = ``-mean(dice)``.
    """
    B, C = logits.shape[0], logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1).reshape(B, -1, C)  # (B, V, C)
    flat_t = target.reshape(B, -1).long()
    onehot = (flat_t.unsqueeze(-1) == torch.arange(C, device=logits.device)).float()
    if loss_mask is not None:
        # the mask enters each product once (as in the reference's
        # MemoryEfficientSoftDiceLoss); masking both factors would square a
        # non-binary weighting in `intersect`
        m = loss_mask.reshape(B, -1, 1).float()
        onehot = onehot * m
        sum_pred = (probs * m).sum(1)
    else:
        sum_pred = probs.sum(1)
    intersect = (probs * onehot).sum(1)  # (B, C)
    sum_gt = onehot.sum(1)
    if not do_bg:
        intersect, sum_gt, sum_pred = intersect[:, 1:], sum_gt[:, 1:], sum_pred[:, 1:]
    if batch_dice:
        intersect, sum_gt, sum_pred = intersect.sum(0), sum_gt.sum(0), sum_pred.sum(0)
    dc = (2.0 * intersect + smooth) / (sum_gt + sum_pred + smooth).clamp(min=1e-8)
    return -dc.mean()


def region_soft_dice_loss(
    logits: torch.Tensor,
    target_regions: torch.Tensor,
    *,
    batch_dice: bool = False,
    smooth: float = 1e-5,
    loss_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sigmoid (multi-label) soft Dice for region-based training: one sigmoid
    channel per region, Dice on the binary region masks, no background
    channel.

    Args:
        logits: ``(B, *sp, R)``.
        target_regions: binary {0,1}, ``(B, *sp, R)``.
    """
    probs = torch.sigmoid(logits.float())
    tgt = target_regions.float()
    if loss_mask is not None:
        m = loss_mask.float().unsqueeze(-1)
        probs = probs * m
        tgt = tgt * m
    spatial = tuple(range(1, logits.dim() - 1))
    intersect = (probs * tgt).sum(spatial)
    sum_pred = probs.sum(spatial)
    sum_gt = tgt.sum(spatial)
    if batch_dice:
        intersect, sum_pred, sum_gt = intersect.sum(0), sum_pred.sum(0), sum_gt.sum(0)
    dice = (2.0 * intersect + smooth) / (sum_pred + sum_gt + smooth)
    return -dice.mean()
