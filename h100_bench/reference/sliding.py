"""nnU-Net's sliding-window inference, plainly: tiles at half-patch steps
(ends aligned), per tile the softmax averaged over every mirror
combination of the mirror axes, weighted by a Gaussian of sigma patch / 8
(maximum 1, floored at its smallest positive value), accumulated and
normalized. Float32 probabilities."""

from __future__ import annotations

import itertools

import numpy as np
import torch


def steps(image, patch, fraction=0.5):
    out = []
    for n, p in zip(image, patch):
        count = int(np.ceil((n - p) / (p * fraction))) + 1
        out.append([int(round(i * (n - p) / (count - 1))) for i in range(count)]
                   if count > 1 else [0])
    return out


def gaussian(patch):
    g = np.ones(())
    for p in patch:
        i = np.arange(p, dtype=np.float64)
        g = np.multiply.outer(g, np.exp(-0.5 * ((i - (p - 1) / 2.0) / (p / 8.0)) ** 2))
    g = g / g.max()
    return np.maximum(g, g[g > 0].min()).astype(np.float32)


@torch.no_grad()
def predict_probs(model, volume: torch.Tensor, patch, mirror_axes, batch: int = 4):
    """``volume (*sp, C_in)`` f32 on the device -> ``(*sp, classes)`` f32.
    ``model(x)`` maps ``(B, *patch, C_in)`` to channels-last logits."""
    combos = [c for r in range(len(mirror_axes) + 1)
              for c in itertools.combinations(mirror_axes, r)]
    sp = volume.shape[:-1]
    g = torch.from_numpy(gaussian(patch)).to(volume.device)
    acc = weight = None
    for corner in itertools.product(*steps(sp, patch)):
        sl = tuple(slice(c, c + p) for c, p in zip(corner, patch))
        tile = volume[sl]
        probs = 0.0
        variants = [torch.flip(tile, [a for a in c]) if c else tile for c in combos]
        for i in range(0, len(variants), batch):
            logits = model(torch.stack(variants[i:i + batch]))
            for c, lg in zip(combos[i:i + batch], logits):
                p = torch.softmax(lg.float(), -1)
                probs = probs + (torch.flip(p, [a for a in c]) if c else p)
        probs = probs / len(combos)
        if acc is None:
            acc = torch.zeros(*sp, probs.shape[-1], device=volume.device)
            weight = torch.zeros(sp, device=volume.device)
        acc[sl] += probs * g[..., None]
        weight[sl] += g
    return acc / weight[..., None]
