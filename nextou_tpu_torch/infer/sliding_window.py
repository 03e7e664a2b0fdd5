"""Gaussian-blended sliding-window inference with mirror TTA, on the device.

Counterpart of ``nextou_tpu/infer/sliding_window.py``: tile the volume with
50%-overlap patches; per tile, average the f32 softmax over every mirror
combination; weight by a Gaussian importance map (sigma = patch / 8);
accumulate; normalize or argmax.

Two ways to accumulate, with one tile forward (:func:`make_tile_predictor`):

- on the device (:func:`make_device_sliding_predictor`): the volume goes to
  the device once (bf16 by default, halving the upload); tiles are cut
  there, the accumulators live there, and only the result comes back;
- on the host (:func:`sliding_window_predict`), for volumes whose
  accumulators do not fit the device: tiles are cut from the host volume
  and uploaded per tile batch, each batch's forwards still run on the
  device, its probabilities come back and are accumulated in f32 host
  memory.

While tracing is on (``trace.py``) each tile batch's TTA is the span
``serve.tile_predict``, each forward in it ``serve.forward``, and the
Gaussian accumulation of a tile batch ``serve.accumulate``.
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from nextou_tpu_torch.trace import span

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


def make_tile_predictor(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    mirror_axes: Sequence[int] | None,
    activation: str = "softmax",
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``tiles (T, *patch, C_in) -> probs (T, *patch, num_classes) f32``, on
    the tiles' device: the activation of ``apply_fn``'s logits averaged over
    every mirror combination. Mirror variants go through the model two at a
    time (batch ``2 T``)."""
    combos = mirror_combinations(mirror_axes)
    act = _activation(activation)

    def tile_forward(tiles: torch.Tensor) -> torch.Tensor:
        with span("serve.tile_predict"):
            total = None
            for g0 in range(0, len(combos), MIRRORS_PER_FORWARD):
                group = combos[g0:g0 + MIRRORS_PER_FORWARD]
                stacked = torch.cat([
                    torch.flip(tiles, [a + 1 for a in c]) if c else tiles
                    for c in group
                ])
                with span("serve.forward"):
                    logits = apply_fn(stacked)
                for c, part in zip(group, logits.chunk(len(group))):
                    if c:
                        part = torch.flip(part, [a + 1 for a in c])
                    probs = act(part.float())
                    total = probs if total is None else total + probs
            return total / float(len(combos))

    return tile_forward


def replicated_forward(models: Sequence[torch.nn.Module]) -> Callable[[torch.Tensor], torch.Tensor]:
    """``tiles (T, ...) -> logits (T, ...)`` with the tiles split over
    ``models``, one replica of a network per device (``parallel/mesh.py::
    replicate_to``), in equal chunks in order: every chunk is launched on its
    device before any is gathered, and the logits are gathered on the first
    device. The counterpart of the JAX package's tile batch sharded over a
    mesh (``--all-devices``)."""
    devices = [next(m.parameters()).device for m in models]

    def forward(tiles: torch.Tensor) -> torch.Tensor:
        chunks = tiles.chunk(len(models))
        if len(chunks) != len(models):
            raise ValueError(f"{tiles.shape[0]} tiles do not split over {len(models)} devices")
        outs = [m(c.to(d, non_blocking=True)) for m, c, d in zip(models, chunks, devices)]
        return torch.cat([o.to(devices[0]) for o in outs])

    return forward


def _tile_batches(coords: list, tile_batch: int, patch: tuple):
    """``(slices, n_real)`` per tile batch; each batch is padded to
    ``tile_batch`` tiles with copies of its last tile, so every forward has
    one batch size, and only its first ``n_real`` tiles are accumulated."""
    for i in range(0, len(coords), tile_batch):
        chunk = coords[i:i + tile_batch]
        n_real = len(chunk)
        chunk = chunk + [chunk[-1]] * (tile_batch - n_real)
        yield [tuple(slice(c, c + p) for c, p in zip(co, patch)) for co in chunk], n_real


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
    ``(B, *patch, num_classes)``; its tile forward is
    :func:`make_tile_predictor`'s, on batches of ``tile_batch`` tiles (the
    last one padded with copies that are never accumulated).
    """
    if output not in ("probs", "seg"):
        raise ValueError(output)
    if output == "seg" and activation != "softmax":
        raise ValueError("output='seg' requires softmax label mode")
    patch = tuple(patch_size)
    tile_forward = make_tile_predictor(apply_fn, mirror_axes, activation)
    gauss = torch.from_numpy(gaussian_importance_map(patch)).to(device)
    seg_dtype = torch.uint8 if num_classes <= 255 else torch.int16

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
        for slices, n_real in _tile_batches(coords, tile_batch, patch):
            probs = tile_forward(torch.stack([vol[sl] for sl in slices]))
            # accumulate in place on the device; padded copies are skipped
            with span("serve.accumulate"):
                for sl, pr in zip(slices[:n_real], probs[:n_real]):
                    acc[sl] += pr * gauss[..., None]
                    weight[sl] += gauss
        crop = tuple(slice(0, s) for s in spatial)
        if output == "seg":
            # argmax(acc / weight) == argmax(acc): weight > 0, equal per class
            return torch.argmax(acc[crop], dim=-1).to(seg_dtype)
        return (acc / weight[..., None])[crop]

    return predict


@torch.inference_mode()
def sliding_window_predict(
    tile_predictor: Callable[[torch.Tensor], torch.Tensor],
    data: np.ndarray,
    patch_size: Sequence[int],
    num_classes: int,
    *,
    device: torch.device | str,
    step_fraction: float = 0.5,
    tile_batch: int = 4,
    transfer_dtype: torch.dtype = torch.bfloat16,
) -> np.ndarray:
    """Class probabilities ``(*sp, num_classes) f32`` of ``data (*sp, C_in)``,
    accumulated in host memory (``nextou_tpu/infer/sliding_window.py::
    sliding_window_predict``).

    Each tile batch is cut from the host volume, cast to ``transfer_dtype``
    (as the device predictor casts the whole volume) and uploaded to
    ``device``, where ``tile_predictor`` (:func:`make_tile_predictor`) runs
    its forwards; the real tiles' probabilities come back and are added into
    f32 numpy accumulators with the Gaussian weights.
    """
    spatial = data.shape[:-1]
    patch = tuple(patch_size)
    pad = [(0, max(0, p - s)) for s, p in zip(spatial, patch)]
    padded = np.pad(data, pad + [(0, 0)]) if any(p[1] for p in pad) else data
    psp = padded.shape[:-1]
    steps = compute_sliding_window_steps(psp, patch, step_fraction)
    coords = list(itertools.product(*steps))
    gauss = gaussian_importance_map(patch)

    acc = np.zeros((*psp, num_classes), np.float32)
    weight = np.zeros(psp, np.float32)
    for slices, n_real in _tile_batches(coords, tile_batch, patch):
        tiles = torch.from_numpy(np.stack([padded[sl] for sl in slices])).to(transfer_dtype)
        probs = tile_predictor(tiles.to(device))[:n_real].cpu().numpy()
        with span("serve.accumulate"):
            for sl, pr in zip(slices, probs):
                acc[sl] += pr * gauss[..., None]
                weight[sl] += gauss
    acc /= weight[..., None]
    return acc[tuple(slice(0, s) for s in spatial)]
