"""Train and eval steps, counterpart of ``nextou_tpu/train/train_step.py``.

bf16 compute with f32 parameters replaces AMP: every layer casts its f32
weights to the compute dtype, so the gradients arrive in f32, and no
``GradScaler`` is needed (bf16 has f32's exponent range). On-device
augmentation inside the step is not ported yet.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from nextou_tpu_torch.losses import (
    CompoundLossSpec,
    dc_ce_ti_loss,
    deep_supervised_loss,
    region_targets,
)
from nextou_tpu_torch.train.optimizer import SGD
from nextou_tpu_torch.train.state import TrainState


def _batch_on(model: nn.Module, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
    device = next(model.parameters()).device
    data = torch.as_tensor(batch["data"]).to(device)
    seg = torch.as_tensor(batch["seg"]).to(device=device, dtype=torch.long)
    return data, seg


def _loss(model, data, seg, loss_spec, ds_weights) -> tuple[torch.Tensor, list]:
    outs = model(data)
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    loss = deep_supervised_loss(
        outs, seg, lambda o, t: dc_ce_ti_loss(o, t, loss_spec), ds_weights
    )
    return loss, outs


def make_train_step(
    model: nn.Module,
    optimizer: SGD,
    loss_spec: CompoundLossSpec,
    ds_weights: Sequence[float] | None = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` = {'data': (B, *sp, C) float, 'seg': (B, *sp) int}, numpy arrays
    or tensors; they are moved to the model's device. ``state`` (which holds
    ``model``) is updated in place and returned. ``metrics`` holds ``loss``
    and ``grad_norm`` (the global norm before clipping) as 0-d tensors on the
    device: reading them waits for the step.
    """

    def train_step(state: TrainState, batch: dict):
        model.train()
        data, seg = _batch_on(model, batch)
        params = list(model.parameters())
        loss, _ = _loss(model, data, seg, loss_spec, ds_weights)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a head whose output has weight 0 gets no gradient: zeros, so that
        # weight decay and momentum still see it
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        norm = optimizer.update(grads, state.momentum, params, state.step)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": norm}

    return train_step


def make_eval_step(
    model: nn.Module,
    loss_spec: CompoundLossSpec,
    ds_weights: Sequence[float] | None = None,
) -> Callable[[TrainState, dict], dict]:
    """Validation step: the deep-supervised loss and the global hard-Dice
    statistics (tp/fp/fn per foreground class, or per region, on the
    full-resolution prediction), as nnU-Net's validation_step. Voxels with
    the ignore label count nowhere."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        model.eval()
        data, seg = _batch_on(model, batch)
        loss, outs = _loss(model, data, seg, loss_spec, ds_weights)
        logits = outs[0]
        valid = None if loss_spec.ignore_label is None else seg != loss_spec.ignore_label
        if loss_spec.regions is not None:
            # region mode: sigmoid > 0.5 per channel (logit > 0)
            gt = region_targets(seg, loss_spec.regions)
            pairs = [(logits[..., i] > 0, gt[..., i]) for i in range(len(loss_spec.regions))]
        else:
            pred = torch.argmax(logits, dim=-1)
            pairs = [(pred == c, seg == c) for c in range(1, logits.shape[-1])]
        tp, fp, fn = [], [], []
        for p, g in pairs:
            if valid is not None:
                p, g = p & valid, g & valid
            tp.append((p & g).sum())
            fp.append((p & ~g).sum())
            fn.append((~p & g).sum())
        return {"loss": loss, "tp": torch.stack(tp), "fp": torch.stack(fp),
                "fn": torch.stack(fn)}

    return eval_step


def pseudo_dice(tp: torch.Tensor, fp: torch.Tensor, fn: torch.Tensor) -> torch.Tensor:
    """Global per-class Dice from aggregated statistics; NaN for a class
    absent from both prediction and ground truth (denominator 0), like
    nnU-Net's 0/0, so that a nanmean skips it."""
    tp, fp, fn = (t.to(torch.float32) for t in (tp, fp, fn))
    denom = 2 * tp + fp + fn
    dice = (2 * tp) / denom.clamp(min=1e-8)
    return torch.where(denom > 0, dice, torch.full_like(dice, float("nan")))
