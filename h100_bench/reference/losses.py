"""The compound loss of the NexToU trainers, plainly (float32): soft Dice
(softmax, no background, batch Dice as the plans say, smooth 1e-5) + cross
entropy + lambda x the topological interaction term of the binary
interaction tree (upstream ``compound_bti_loss.py``, ``bti_loss.py``:
critical voxels where a dilated label set meets the other set of an
exclusion pair, on the argmax; CE masked by them, summed over space, meaned
over the batch), over the deep-supervision outputs with weights 1/2^i, the
lowest zeroed, normalized; targets downsampled by strided slicing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ds_weights(n: int) -> list[float]:
    if n == 1:
        return [1.0]
    w = [1.0 / 2**i for i in range(n)]
    w[-1] = 0.0
    total = sum(w)
    return [x / total for x in w]


def _label_set(v) -> tuple[int, ...]:
    return tuple(v) if isinstance(v, (list, tuple)) else (int(v),)


def _in(p, labels):
    m = torch.zeros_like(p, dtype=torch.bool)
    for label in labels:
        m |= p == label
    return m


def critical_map(pred: torch.Tensor, exclusion, connectivity: int) -> torch.Tensor:
    """``(B, *sp)`` labels -> ``{0, 1}`` f32 critical voxels of the exclusion
    pairs, dilating with the full 3^d neighbourhood (26 in 3D, 8 in 2D)."""
    d = pred.dim() - 1
    if connectivity != 3**d - 1:
        raise ValueError(f"connectivity {connectivity} in {d}D")
    pool = F.max_pool3d if d == 3 else F.max_pool2d

    def dilate(m):
        return pool(m.float().unsqueeze(1), 3, 1, 1)[:, 0] > 0

    crit = torch.zeros_like(pred, dtype=torch.bool)
    for a, c in exclusion:
        ma, mc = _in(pred, _label_set(a)), _in(pred, _label_set(c))
        crit |= (dilate(mc) & ma) | (dilate(ma) & mc)
    return crit.float()


def compound_loss(logits: torch.Tensor, target: torch.Tensor, loss_cfg: dict) -> torch.Tensor:
    """``logits (B, *sp, C)``, ``target (B, *sp)`` int64 -> scalar."""
    B, C = logits.shape[0], logits.shape[-1]
    lf = logits.float()
    probs = torch.softmax(lf, -1).reshape(B, -1, C)
    onehot = F.one_hot(target.reshape(B, -1), C).float()
    inter, s_gt, s_pred = (probs * onehot).sum(1), onehot.sum(1), probs.sum(1)
    inter, s_gt, s_pred = inter[:, 1:], s_gt[:, 1:], s_pred[:, 1:]
    if loss_cfg["batch_dice"]:
        inter, s_gt, s_pred = inter.sum(0), s_gt.sum(0), s_pred.sum(0)
    dice = (2 * inter + 1e-5) / (s_gt + s_pred + 1e-5).clamp(min=1e-8)
    ce = -torch.log_softmax(lf, -1).gather(-1, target.unsqueeze(-1)).squeeze(-1)
    total = loss_cfg["weight_dice"] * -dice.mean() + loss_cfg["weight_ce"] * ce.mean()
    if loss_cfg["weight_ti"]:
        with torch.no_grad():
            crit = critical_map(lf.argmax(-1), loss_cfg["exclusion"], loss_cfg["connectivity"])
        ti = (ce * crit).reshape(B, -1).sum(1).mean()
        total = total + loss_cfg["weight_ti"] * ti
    return total


def deep_supervised(outs, target: torch.Tensor, loss_cfg: dict) -> torch.Tensor:
    total = torch.zeros((), device=target.device)
    for w, out in zip(ds_weights(len(outs)), outs):
        if w == 0.0:
            continue
        sl = [slice(None)] + [slice(None, None, s // o)
                              for s, o in zip(target.shape[1:], out.shape[1:-1])]
        total = total + w * compound_loss(out, target[tuple(sl)], loss_cfg)
    return total
