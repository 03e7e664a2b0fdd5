"""Seeded host-side initialization, counterpart of the rules of
``nextou_tpu/utils/init.py`` (upstream ``InitWeights_He(1e-2)``):

- every conv-shaped weight (conv, 1x1, grouped 1x1, transposed conv): He
  normal, ``std = sqrt(2 / (1 + 0.01^2) / fan_in)`` with torch's fan-in,
  ``weight.shape[1] * prod(kernel)`` (for a ConvTranspose that is
  ``C_out * prod(k)``, as upstream's kaiming_normal_ computes it);
- biases 0, norm scales 1, BatchNorm running mean/var 0/1;
- relative-position tables are left as the model built them.

Draws come from ``numpy.random.default_rng(seed)`` in parameter order, so a
seed gives the same weights on any device. They are not jax's draws: tests
move weights between the packages with ``compat.weights``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from nextou_tpu_torch.nn.layers import HE_GAIN_SQ


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    rng = np.random.default_rng(seed)
    for name, p in model.named_parameters():
        if p.dim() >= 2:
            fan_in = p.shape[1] * math.prod(p.shape[2:])
            w = (HE_GAIN_SQ / fan_in) ** 0.5 * rng.standard_normal(tuple(p.shape))
            p.copy_(torch.from_numpy(w.astype(np.float32)))
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.fill_(1.0)
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.zero_()
        elif name.endswith("running_var"):
            b.fill_(1.0)
    return model
