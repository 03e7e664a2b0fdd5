"""Gaussian-blended sliding-window inference with mirror TTA, on the device.

Counterpart of ``nextou_tpu/infer/sliding_window.py``: tile the volume with
50%-overlap patches; per tile, average the f32 softmax over every mirror
combination; weight by a Gaussian importance map (sigma = patch / 8);
accumulate; normalize or argmax.

The volume goes to the device once (bf16 by default, halving the upload);
tiles are cut there, the accumulators live there, and only the result comes
back. The host-accumulation fallback for volumes whose accumulators do not
fit the device is not ported yet.
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np
import torch

MIRRORS_PER_FORWARD = 2  # mirror variants stacked into one forward


def compute_sliding_window_steps(
    image_size: Sequence[int], patch_size: Sequence[int], step_fraction: float = 0.5
) -> list[list[int]]:
    """Per-axis tile start coordinates (nnU-Net's algorithm: cover the volume
    with >= 1/step_fraction overlap, ends aligned)."""
    steps = []
    for img, patch in zip(image_size, patch_size):
        assert img >= patch, (image_size, patch_size)
        target = patch * step_fraction
        num = int(np.ceil((img - patch) / target)) + 1
        if num > 1:
            actual = (img - patch) / (num - 1)
            steps.append([int(round(i * actual)) for i in range(num)])
        else:
            steps.append([0])
    return steps


def gaussian_importance_map(
    patch_size: Sequence[int], sigma_scale: float = 1.0 / 8
) -> np.ndarray:
    """Separable Gaussian centered on the patch, max 1, strictly positive."""
    axes = []
    for p in patch_size:
        c = (p - 1) / 2.0
        sigma = p * sigma_scale
        i = np.arange(p, dtype=np.float64)
        axes.append(np.exp(-0.5 * ((i - c) / sigma) ** 2))
    g = axes[0]
    for a in axes[1:]:
        g = np.multiply.outer(g, a)
    g = g / g.max()
    g = np.maximum(g, g[g > 0].min())
    return g.astype(np.float32)


def _activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """'softmax' (label mode) or 'sigmoid' (region-based labels)."""
    if name == "softmax":
        return lambda x: torch.softmax(x, dim=-1)
    if name == "sigmoid":
        return torch.sigmoid
    raise ValueError(f"unknown activation '{name}'")


def mirror_combinations(mirror_axes: Sequence[int] | None) -> list[tuple[int, ...]]:
    """Every subset of the spatial mirror axes, the empty one first."""
    axes = tuple(mirror_axes) if mirror_axes else ()
    return [c for r in range(len(axes) + 1) for c in itertools.combinations(axes, r)]


def make_device_sliding_predictor(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    mirror_axes: Sequence[int] | None,
    patch_size: Sequence[int],
    num_classes: int,
    *,
    device: torch.device | str,
    tile_batch: int = 4,
    activation: str = "softmax",
    output: str = "probs",
    transfer_dtype: torch.dtype = torch.bfloat16,
    step_fraction: float = 0.5,
) -> Callable[[np.ndarray], torch.Tensor]:
    """Build ``predict(data (*sp, C_in)) -> probs (*sp, num_classes) f32``, or
    with ``output='seg'`` (softmax only) the argmax ``(*sp)`` as uint8 (int16
    above 255 classes), both on ``device``.

    ``apply_fn`` maps ``(B, *patch, C_in)`` to full-resolution logits
    ``(B, *patch, num_classes)``. Each tile batch is padded to ``tile_batch``
    tiles with copies of its last tile, so every forward has one batch size;
    the copies are never accumulated. Mirror variants go through the model
    two at a time (batch ``2 * tile_batch``).
    """
    if output not in ("probs", "seg"):
        raise ValueError(output)
    if output == "seg" and activation != "softmax":
        raise ValueError("output='seg' requires softmax label mode")
    patch = tuple(patch_size)
    combos = mirror_combinations(mirror_axes)
    act = _activation(activation)
    gauss = torch.from_numpy(gaussian_importance_map(patch)).to(device)
    seg_dtype = torch.uint8 if num_classes <= 255 else torch.int16

    def tile_forward(tiles: torch.Tensor) -> torch.Tensor:
        total = None
        for g0 in range(0, len(combos), MIRRORS_PER_FORWARD):
            group = combos[g0:g0 + MIRRORS_PER_FORWARD]
            stacked = torch.cat([
                torch.flip(tiles, [a + 1 for a in c]) if c else tiles
                for c in group
            ])
            logits = apply_fn(stacked)
            for c, part in zip(group, logits.chunk(len(group))):
                if c:
                    part = torch.flip(part, [a + 1 for a in c])
                probs = act(part.float())
                total = probs if total is None else total + probs
        return total / float(len(combos))

    @torch.inference_mode()
    def predict(data: np.ndarray) -> torch.Tensor:
        spatial = data.shape[:-1]
        pad = [(0, max(0, p - s)) for s, p in zip(spatial, patch)]
        if any(p[1] for p in pad):
            data = np.pad(data, pad + [(0, 0)])
        vol = torch.from_numpy(np.ascontiguousarray(data)).to(transfer_dtype)
        vol = vol.to(device)
        psp = tuple(vol.shape[:-1])
        steps = compute_sliding_window_steps(psp, patch, step_fraction)
        coords = list(itertools.product(*steps))
        acc = torch.zeros(*psp, num_classes, dtype=torch.float32, device=device)
        weight = torch.zeros(psp, dtype=torch.float32, device=device)
        for i in range(0, len(coords), tile_batch):
            chunk = coords[i:i + tile_batch]
            n_real = len(chunk)
            chunk = chunk + [chunk[-1]] * (tile_batch - n_real)
            slices = [tuple(slice(c, c + p) for c, p in zip(co, patch)) for co in chunk]
            probs = tile_forward(torch.stack([vol[sl] for sl in slices]))
            # accumulate in place on the device; padded copies are skipped
            for sl, pr in zip(slices[:n_real], probs[:n_real]):
                acc[sl] += pr * gauss[..., None]
                weight[sl] += gauss
        crop = tuple(slice(0, s) for s in spatial)
        if output == "seg":
            # argmax(acc / weight) == argmax(acc): weight > 0, equal per class
            return torch.argmax(acc[crop], dim=-1).to(seg_dtype)
        return (acc / weight[..., None])[crop]

    return predict
