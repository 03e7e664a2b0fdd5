"""Replicas of a network, counterpart of ``nextou_tpu/parallel/mesh.py``.

The JAX package replicates the train state over a mesh (``replicate``) and
shards the batch on its 'data' axis (``shard_batch``); serving with
``--all-devices`` shards the tile batch the same way. Here a rank already
holds its own share of the batch, so what is left is: the same parameters
and BatchNorm statistics on every rank (:func:`broadcast_module`), and for
serving one replica of the network on each of this process's devices
(:func:`local_devices`, :func:`replicate_to`).
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn

from nextou_tpu_torch.parallel.distributed import world_size


def broadcast_module(model: nn.Module, src: int = 0) -> nn.Module:
    """Rank ``src``'s parameters and buffers on every rank, in place (every
    rank also seeds its initialization alike). Nothing happens without a
    process group of more than one rank."""
    if world_size() > 1:
        with torch.no_grad():
            for t in (*model.parameters(), *model.buffers()):
                dist.broadcast(t.data, src)
    return model


def local_devices(device: str | torch.device) -> list[torch.device]:
    """Every device of ``device``'s type that this process sees, ``device``
    first: each CUDA card, or the one CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device]
    first = torch.cuda.current_device() if device.index is None else device.index
    others = [i for i in range(torch.cuda.device_count()) if i != first]
    return [torch.device("cuda", i) for i in (first, *others)]


def replicate_to(model: nn.Module, devices: Sequence[torch.device]) -> list[nn.Module]:
    """``model`` itself on the first of ``devices`` (where it must lie) and a
    copy of it on each of the others, in the same mode."""
    devices = [torch.device(d) for d in devices]
    home = next(model.parameters()).device
    if devices[0] != home:
        raise ValueError(f"the model lies on {home}, the first device is {devices[0]}")
    return [model] + [copy.deepcopy(model).to(d) for d in devices[1:]]
