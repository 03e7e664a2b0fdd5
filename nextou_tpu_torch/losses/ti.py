"""Topological Interaction (TI) and Binary TI (BTI) losses, counterpart of
``nextou_tpu/losses/ti.py`` (upstream ``loss/ti_loss.py`` and
``bti_loss.py``: identical control flow; BTI generalizes scalar class labels
to label *sets*). One spec expresses both: a TI interaction is a BTI
interaction with singleton label sets.

Algorithm per interaction ``(type, A, C)`` (upstream ``bti_loss.py:76-117``):
  1. discrete map ``P = argmax(logits)``;
  2. ``mask_A = P in A``; inclusion: ``mask_C = not (P in C or mask_A)``,
     exclusion: ``mask_C = P in C``;
  3. dilate both by the connectivity kernel (conv + threshold >= 1);
  4. critical = (dilate(C) and A) or (dilate(A) and C); OR-accumulate.
Loss = per-voxel CE masked by the critical map, summed over space, meaned
over batch.

The critical map is integer work: {0,1} masks and neighbour counts of at
most 27, exact in f32 (and in TF32, should a card's conv use it), so it is
bit-identical to ``nextou_tpu.losses.ti`` on the same label map.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from nextou_tpu_torch.losses.ce import cross_entropy_elementwise


def _connectivity_kernel(dim: int, connectivity: int, min_thick: int) -> np.ndarray:
    """The dilation structuring element (upstream ``bti_loss.py:52-73``)."""
    k = 2 * min_thick + 1
    if dim == 2:
        if connectivity == 4:
            return np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.float32)
        if connectivity == 8:
            return np.ones((k, k), np.float32)
    elif dim == 3:
        if connectivity == 6:
            kern = np.zeros((3, 3, 3), np.float32)
            kern[1, 1, :] = kern[1, :, 1] = kern[:, 1, 1] = 1
            return kern
        if connectivity == 26:
            return np.ones((k, k, k), np.float32)
    raise ValueError(f"unsupported dim={dim} connectivity={connectivity}")


def _normalize_label_sets(pairs) -> tuple[tuple[tuple[int, ...], tuple[int, ...]], ...]:
    """Each interaction entry is ``[A, C]`` with scalar or list members: the
    upstream trainers pass entries like ``[[1, 3], [11, 13]]`` (set against
    set) and ``[1, 3]`` (scalar against scalar) interchangeably."""
    out = []
    for pair in pairs:
        a, c = pair[0], pair[1]
        a = tuple(a) if isinstance(a, (list, tuple)) else (int(a),)
        c = tuple(c) if isinstance(c, (list, tuple)) else (int(c),)
        out.append((a, c))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class TILossSpec:
    """Static configuration of a TI/BTI loss term."""

    dim: int = 3
    connectivity: int = 26
    min_thick: int = 1
    # interactions: (is_inclusion, A labels, C labels)
    interactions: tuple[tuple[bool, tuple[int, ...], tuple[int, ...]], ...] = ()

    @classmethod
    def create(
        cls,
        dim: int,
        connectivity: int,
        inclusion: Sequence = (),
        exclusion: Sequence = (),
        min_thick: int = 1,
    ) -> "TILossSpec":
        inter = tuple(
            (True, a, c) for a, c in _normalize_label_sets(inclusion)
        ) + tuple((False, a, c) for a, c in _normalize_label_sets(exclusion))
        return cls(dim=dim, connectivity=connectivity, min_thick=min_thick,
                   interactions=inter)


def _isin(p: torch.Tensor, labels: tuple[int, ...]) -> torch.Tensor:
    m = p == labels[0]
    for label in labels[1:]:
        m = m | (p == label)
    return m


def _dilate(mask: torch.Tensor, kernel: torch.Tensor, dim: int) -> torch.Tensor:
    """Binary dilation of ``(B, *sp)`` masks: conv with the structuring
    element (zero padding, same size), thresholded at 1."""
    conv = F.conv2d if dim == 2 else F.conv3d
    pad = tuple(s // 2 for s in kernel.shape)
    y = conv(mask.float().unsqueeze(1), kernel[None, None], padding=pad)
    return y[:, 0] >= 1.0


def critical_voxels_map(p: torch.Tensor, spec: TILossSpec) -> torch.Tensor:
    """Critical voxel mask (f32 {0,1}) of a discrete label map ``p (B, *sp)``."""
    kernel = torch.from_numpy(
        _connectivity_kernel(spec.dim, spec.connectivity, spec.min_thick)
    ).to(p.device)
    crit = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    for is_inclusion, labels_a, labels_c in spec.interactions:
        mask_a = _isin(p, labels_a)
        if is_inclusion:
            mask_c = ~(_isin(p, labels_c) | mask_a)
        else:
            mask_c = _isin(p, labels_c)
        neigh_c = _dilate(mask_c, kernel, spec.dim)
        neigh_a = _dilate(mask_a, kernel, spec.dim)
        crit = crit | (neigh_c & mask_a) | (neigh_a & mask_c)
    return crit.float()


def ti_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    spec: TILossSpec,
    loss_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """TI/BTI loss: critical-voxel-masked CE, space-summed, batch-meaned.

    Args:
        logits: ``(B, *sp, C)``; target: ``(B, *sp)`` int.
        loss_mask: optional ``(B, *sp)`` bool: voxels outside it (an ignore
            label) can neither be critical nor contribute CE.
    """
    if not spec.interactions:
        return torch.zeros((), dtype=torch.float32, device=logits.device)
    with torch.no_grad():
        crit = critical_voxels_map(torch.argmax(logits, dim=-1), spec)
        if loss_mask is not None:
            crit = crit * loss_mask.to(crit.dtype)
    ce = cross_entropy_elementwise(logits, target)
    return (ce * crit).sum(tuple(range(1, ce.dim()))).mean()
