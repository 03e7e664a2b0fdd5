"""Synthetic preprocessed datasets for tests and demos.

Counterpart of ``nextou_tpu/data/synthetic.py`` (numpy only): blob-world
volumes, random soft ellipsoids per foreground class with a class-dependent
intensity plus noise, so a few hundred training steps reach a high Dice.
The same seed writes the same cases, bit for bit, as the JAX package's.
"""

from __future__ import annotations

import os

import numpy as np

from nextou_tpu_torch.data.dataset import save_case


def make_synthetic_case(
    rng: np.random.Generator,
    shape,
    num_classes: int,
    n_blobs: int = 3,
) -> tuple[np.ndarray, np.ndarray]:
    """``(data, seg)``: (1, *shape) float32 and (*shape) int16."""
    dim = len(shape)
    seg = np.zeros(shape, np.int16)
    grid = np.stack(
        np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    )
    for c in range(1, num_classes):
        for _ in range(n_blobs):
            center = np.array([rng.uniform(0.2 * s, 0.8 * s) for s in shape])
            radii = np.array([rng.uniform(0.06 * s, 0.18 * s) for s in shape])
            d = (((grid - center.reshape(dim, *[1] * dim)) /
                  radii.reshape(dim, *[1] * dim)) ** 2).sum(0)
            # paint on background only: a later class must not erase an
            # earlier one (an occluded class cannot be learnt)
            seg[np.logical_and(d <= 1.0, seg == 0)] = c
    intensity = np.take(np.linspace(-1.0, 1.0, num_classes).astype(np.float32), seg)
    data = intensity + rng.normal(0, 0.15, shape).astype(np.float32)
    return data[None], seg


def make_synthetic_dataset(
    folder: str,
    n_cases: int = 8,
    shape=(48, 48),
    num_classes: int = 3,
    seed: int = 0,
) -> list[str]:
    """Write ``n_cases`` cases ``case_000 ...`` into ``folder`` in the
    preprocessed layout (``data/dataset.py::save_case``); returns their ids."""
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    ids = []
    for i in range(n_cases):
        cid = f"case_{i:03d}"
        data, seg = make_synthetic_case(rng, shape, num_classes)
        save_case(folder, cid, data, seg)
        ids.append(cid)
    return ids
