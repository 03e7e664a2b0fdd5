"""The feature-map estimate of nnU-Net's experiment planner.

The port's own copy of ``compute_conv_feature_map_size`` from
``nextou_tpu/plans/planner.py`` (pure arithmetic); the rest of the planner
(fingerprint to plans) is not ported yet. The trainer reads the estimate to
choose its recomputation (``train/trainer.py``).
"""

from __future__ import annotations

import math
from typing import Sequence


def compute_conv_feature_map_size(
    patch_size: Sequence[int],
    features: Sequence[int],
    pool_kernels: Sequence[Sequence[int]],
    n_conv_enc: Sequence[int],
    n_conv_dec: Sequence[int],
    num_classes: int = 0,
) -> int:
    """Total conv output elements of a PlainConv U-Net forward (the VRAM
    proxy nnU-Net's planner compares against its reference budget):
    encoder conv outputs + decoder transpconv/conv outputs + the final
    full-resolution segmentation head (deep-supervision heads excluded)."""
    sizes = []
    cur = list(patch_size)
    total = 0
    for s, stride in enumerate(pool_kernels):
        cur = [math.ceil(c / st) for c, st in zip(cur, stride)]
        sizes.append(list(cur))
        total += n_conv_enc[s] * features[s] * math.prod(cur)
    n_stages = len(pool_kernels)
    for t in range(n_stages - 1):
        skip = sizes[n_stages - 2 - t]
        f = features[n_stages - 2 - t]
        vox = math.prod(skip)
        total += f * vox  # transposed conv output
        total += n_conv_dec[t] * f * vox
    total += num_classes * math.prod(sizes[0])  # final seg head
    return total
