"""Checkpoint save and restore, counterpart of ``nextou_tpu/train/checkpoint.py``
in torch's format.

A checkpoint is one ``torch.save`` file, ``checkpoint_{best,latest,final}.pth``
in the layout of upstream nnU-Net's: the network under ``'network_weights'``
(so that ``nextou_tpu_torch.predict`` serves it with ``torch.load(...,
weights_only=True)``), the optimizer's momentum and step under
``'optimizer_state'``, the model's generator state, and the trainer's own
entries (epoch, EMA pseudo-Dice, best EMA, the per-epoch history) as plain
Python values. Everything in it loads with ``weights_only=True``.

A ``nextou_tpu`` ``.ckpt`` (flax msgpack in a pickle), read by
:mod:`nextou_tpu_torch.compat.flax_ckpt` without jax, flax or msgpack, seeds
``-pretrained_weights`` too, and :func:`load_checkpoint` resumes a training
from one: the network, the BatchNorm statistics, optax's momentum and the
step load into the port's state (``compat.load_train_state``). The JAX
state's ``rng`` has no torch counterpart, so the model's generator keeps
its own state: the draws after a resume (DropPath, the stochastic graph)
do not continue the JAX run's sequence.
"""

from __future__ import annotations

import os
from typing import Any

import torch

from nextou_tpu_torch.compat.flax_ckpt import read_ckpt
from nextou_tpu_torch.compat.weights import (
    extract_network_weights,
    load_train_state,
    variables_to_state_dict,
)
from nextou_tpu_torch.train.state import TrainState

# the entries that nextou_tpu/train/trainer.py::save_checkpoint names
# otherwise, under the names this port's trainer writes and reads
_JAX_EXTRA_NAMES = {"epoch": "current_epoch", "best_ema": "_best_ema", "log_history": "logging"}


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
    """Restore ``state`` in place from ``path``, a checkpoint of this port
    or a ``nextou_tpu`` ``.ckpt``; returns it and the checkpoint's other
    entries (a ``.ckpt``'s under this port's names)."""
    if path.endswith(".ckpt"):
        ckpt = read_ckpt(path)
        if ckpt.momentum is None:
            raise ValueError(f"{path} holds no optimizer trace to resume from")
        load_train_state(state, ckpt.variables, ckpt.momentum, ckpt.step, state.model.spec)
        return state, {_JAX_EXTRA_NAMES.get(k, k): v for k, v in ckpt.extra.items()}
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
        src = variables_to_state_dict(read_ckpt(path).variables, state.model.spec, lenient=True)
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
