"""Checkpoint save and restore, counterpart of ``nextou_tpu/train/checkpoint.py``
in torch's format.

A checkpoint is one ``torch.save`` file, ``checkpoint_{best,latest,final}.pth``
in the layout of upstream nnU-Net's: the network under ``'network_weights'``
(so that ``nextou_tpu_torch.predict`` serves it with ``torch.load(...,
weights_only=True)``), the optimizer's momentum and step under
``'optimizer_state'``, the model's generator state, and the trainer's own
entries (epoch, EMA pseudo-Dice, best EMA, the per-epoch history) as plain
Python values. Everything in it loads with ``weights_only=True``.

A ``nextou_tpu`` ``.ckpt`` (flax msgpack in a pickle) seeds
``-pretrained_weights`` too, read by :mod:`nextou_tpu_torch.compat.flax_ckpt`
without jax, flax or msgpack. Resuming a training (``--c``) from one is not
supported: the optimizer state's layout (optax's) is not the port's.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from nextou_tpu_torch.compat.flax_ckpt import read_ckpt
from nextou_tpu_torch.compat.weights import extract_network_weights, variables_to_state_dict
from nextou_tpu_torch.train.state import TrainState


def save_checkpoint(path: str, state: TrainState, extra: dict[str, Any] | None = None) -> None:
    """Write ``state`` and ``extra`` (plain Python values) to ``path``,
    atomically: a reader never sees half a file."""
    sd = state.state_dict()
    payload = {
        "network_weights": sd["model"],
        "optimizer_state": {"momentum": sd["momentum"], "step": sd["step"]},
        "generator": sd["generator"],
        **(extra or {}),
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, state: TrainState) -> tuple[TrainState, dict]:
    """Restore ``state`` in place from ``path``; returns it and the
    checkpoint's other entries."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    opt = ckpt.pop("optimizer_state")
    state.load_state_dict({
        "model": ckpt.pop("network_weights"), "momentum": opt["momentum"], "step": opt["step"],
        "generator": ckpt.pop("generator").cpu(),
    })
    return state, ckpt


def restore_pretrained(state: TrainState, path: str) -> tuple[TrainState, dict]:
    """``nnUNetv2_train -pretrained_weights``: seed a fresh training with the
    network weights of another run (a checkpoint of this port or of upstream
    nnU-Net, or a ``nextou_tpu`` ``.ckpt``). Every entry of the model's
    ``state_dict`` (parameters, BatchNorm statistics, the position tables)
    whose name exists in both with the same shape is copied; the others keep
    their fresh values, and momentum, step and generator stay as they are.

    From a ``.ckpt`` the entries are those of its ``params`` and
    ``batch_stats``, as ``nextou_tpu/train/checkpoint.py::restore_pretrained``
    takes them: the position tables and BatchNorm's ``num_batches_tracked``
    stay out of the report, so that it counts what the JAX package's counts.

    Returns ``(state, report)`` with report = {'loaded': [...],
    'skipped_shape': [...], 'missing': [...]}.
    """
    device = next(state.model.parameters()).device
    own = state.model.state_dict()
    if path.endswith(".ckpt"):
        src = variables_to_state_dict(read_ckpt(path)[0], state.model.spec, lenient=True)
        # every other entry maps from a params or batch_stats leaf
        own = {k: v for k, v in own.items()
               if not k.endswith((".num_batches_tracked", "relative_pos"))}
    else:
        src = extract_network_weights(torch.load(path, map_location=device, weights_only=True))
    report = {"loaded": [], "skipped_shape": [], "missing": []}
    with torch.no_grad():
        for name, have in own.items():
            new = src.get(name)
            if new is None:
                report["missing"].append(name)
            elif tuple(new.shape) != tuple(have.shape):
                report["skipped_shape"].append(name)
            else:
                have.copy_(new)
                report["loaded"].append(name)
    return state, report
