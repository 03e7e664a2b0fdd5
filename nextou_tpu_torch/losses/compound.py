"""Compound Dice + CE + TI/BTI loss, counterpart of
``nextou_tpu/losses/compound.py``.

Equivalent of upstream ``DC_and_CE_and_TI_Loss`` / ``DC_and_CE_and_BTI_Loss``:
the two differ only in the label-set semantics already folded into
:class:`TILossSpec`. Upstream defaults: weight_ce = weight_dice = 1,
weight_ti = 1e-6 (3D) / 1e-4 (2D).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from nextou_tpu_torch.losses.ce import cross_entropy_loss
from nextou_tpu_torch.losses.dice import region_soft_dice_loss, soft_dice_loss
from nextou_tpu_torch.losses.ti import TILossSpec, ti_loss
from nextou_tpu_torch.parallel.distributed import mean_over_ranks


@dataclasses.dataclass(frozen=True)
class CompoundLossSpec:
    weight_ce: float = 1.0
    weight_dice: float = 1.0
    weight_ti: float = 0.0
    batch_dice: bool = True
    smooth: float = 1e-5
    do_bg: bool = False
    ignore_label: int | None = None
    ti: TILossSpec | None = None
    # region-based training (nnU-Net's list-valued labels +
    # regions_class_order): one sigmoid channel per region; Dice on binary
    # region masks + BCE instead of softmax Dice + CE.
    regions: tuple[tuple[int, ...], ...] | None = None


def region_targets(
    target: torch.Tensor, regions: tuple[tuple[int, ...], ...]
) -> torch.Tensor:
    """``(B, *sp)`` int labels -> ``(B, *sp, R)`` bool region masks
    (membership in each region's label set)."""
    masks = []
    for region in regions:
        m = torch.zeros(target.shape, dtype=torch.bool, device=target.device)
        for label in region:
            m = m | (target == label)
        masks.append(m)
    return torch.stack(masks, dim=-1)


def dc_ce_ti_loss(
    logits: torch.Tensor, target: torch.Tensor, spec: CompoundLossSpec
) -> torch.Tensor:
    """logits ``(B, *sp, C)``, target ``(B, *sp)`` int -> scalar f32.

    Ignore-label handling mirrors upstream ``compound_bti_loss.py:40-57``:
    the Dice term is masked, the CE term uses ignore_index, and ignored
    voxels are replaced by 0 for the Dice one-hot.
    """
    if spec.ignore_label is not None:
        loss_mask = target != spec.ignore_label
        target_dice = torch.where(loss_mask, target, torch.zeros_like(target))
    else:
        target_dice = target
        loss_mask = None

    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    if spec.regions is not None:
        if spec.weight_ti != 0 and spec.ti is not None and spec.ti.interactions:
            raise NotImplementedError(
                "TI/BTI loss with region-based training is not supported: the "
                "TI losses work on integer label maps, not sigmoid region "
                "channels. Drop the regions or the TI interactions."
            )
        tgt_r = region_targets(target_dice, spec.regions).float()
        if spec.weight_dice != 0:
            total = total + spec.weight_dice * region_soft_dice_loss(
                logits, tgt_r, batch_dice=spec.batch_dice, smooth=spec.smooth,
                loss_mask=loss_mask,
            )
        if spec.weight_ce != 0:  # BCE plays CE's role in region mode
            lf = logits.float()
            bce = -(tgt_r * F.logsigmoid(lf) + (1.0 - tgt_r) * F.logsigmoid(-lf))
            # nnU-Net's DC_and_BCE_loss with a mask: (bce * mask).sum() /
            # mask.sum(); the mask broadcasts over the R region channels in
            # the numerator while the denominator counts each voxel once
            m = None if loss_mask is None else loss_mask.float().unsqueeze(-1)
            total = total + spec.weight_ce * mean_over_ranks(bce, m, 1e-8)
        return total

    if spec.weight_dice != 0:
        total = total + spec.weight_dice * soft_dice_loss(
            logits, target_dice, batch_dice=spec.batch_dice, do_bg=spec.do_bg,
            smooth=spec.smooth, loss_mask=loss_mask,
        )
    if spec.weight_ce != 0:
        total = total + spec.weight_ce * cross_entropy_loss(
            logits, target, ignore_index=spec.ignore_label
        )
    if spec.weight_ti != 0 and spec.ti is not None and spec.ti.interactions:
        # the target is clamped into range for the CE gather and the critical
        # map is ANDed with the loss mask, so ignored voxels never contribute
        total = total + spec.weight_ti * ti_loss(
            logits, target_dice, spec.ti, loss_mask=loss_mask
        )
    return total
