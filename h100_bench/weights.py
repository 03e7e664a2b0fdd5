"""Seeded network weights, made by the benchmark and handed to both sides.

He-normal conv-shaped weights (``std = sqrt(2 / (1 + 0.01^2) / fan_in)``,
``fan_in = shape[1] x prod(kernel)``, upstream's ``InitWeights_He(1e-2)``),
zero biases and unit norm scales, drawn on the device from one
``torch.Generator`` seeded with the run's seed, in one call for all of them.
The names and shapes are the reference network's, which are upstream's.

The one departure from upstream's initialization: the scale of the
BatchNorm that closes each residual branch of a GNN block (``fc2.1.weight``
of every grapher and FFN) starts at ``branch_scale`` instead of 1, as a
small-gamma residual initialization does. With unit scales a random NexToU
is chaotic: rounding at the 1e-5 level flips near ties of kNN selections
whose effect compounds through fourteen graphers, so that any computation
in another order parts from float32 on a fifth of the served voxels and
lower precisions cannot be told apart from bf16. The graphers still carry
every kNN kernel's result into the output, a tenth as strongly.
"""

from __future__ import annotations

import math

import torch

HE_GAIN_SQ = 2.0 / (1.0 + 1e-2 ** 2)


@torch.no_grad()
def param_shapes(spec) -> list[tuple[str, tuple]]:
    """``[(name, shape)]`` of the reference network of ``spec``."""
    from h100_bench.reference.network import NexToU

    return [(n, tuple(p.shape)) for n, p in NexToU(spec).named_parameters()]


def make_weights(named_shapes: list[tuple[str, tuple]], seed: int, device,
                 branch_scale: float = 1.0) -> dict:
    """``{name: f32 tensor}`` on ``device`` for ``[(name, shape)]``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    convs = [(n, s) for n, s in named_shapes if len(s) >= 2]
    total = sum(math.prod(s) for _, s in convs)
    draws = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in named_shapes:
        if len(shape) >= 2:
            n = math.prod(shape)
            std = (HE_GAIN_SQ / (shape[1] * math.prod(shape[2:]))) ** 0.5
            out[name] = (draws[at:at + n] * std).reshape(shape)
            at += n
        elif name.endswith("bias"):
            out[name] = torch.zeros(shape, device=device)
        else:
            scale = branch_scale if name.endswith("fc2.1.weight") else 1.0
            out[name] = torch.full(shape, scale, device=device)
    return out


def load_into(model: torch.nn.Module, weights: dict, stats: dict | None = None) -> None:
    """Copy ``weights`` into ``model``'s parameters, and ``stats`` (BatchNorm
    running statistics by name) into its buffers; raise unless the weights
    are exactly its parameters, by name and shape."""
    params = dict(model.named_parameters())
    buffers = dict(model.named_buffers())
    for name, t in (stats or {}).items():
        with torch.no_grad():
            buffers[name].copy_(t)
    if params.keys() != weights.keys():
        missing, extra = params.keys() - weights.keys(), weights.keys() - params.keys()
        raise KeyError(f"weights do not match the network: missing {sorted(missing)[:5]}, "
                       f"extra {sorted(extra)[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: {tuple(p.shape)} against {tuple(weights[name].shape)}")
            p.copy_(weights[name])


def running_stats(model: torch.nn.Module) -> dict:
    """The BatchNorm running statistics of the reference network, by name."""
    return {n: b.detach().clone() for n, b in model.named_buffers()
            if n.endswith(("running_mean", "running_var"))}
