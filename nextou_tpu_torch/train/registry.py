"""Trainer registry, counterpart of ``nextou_tpu/train/registry.py``.

The reference's extension mechanism is 'trainer class selected by name on
the CLI'; this registry keeps that surface with the reference's names.
"""

from __future__ import annotations

TRAINER_REGISTRY: dict[str, type] = {}


def register_trainer(cls):
    TRAINER_REGISTRY[cls.__name__] = cls
    return cls


def get_trainer_class(name: str):
    if name not in TRAINER_REGISTRY:
        raise KeyError(f"unknown trainer '{name}'; available: {sorted(TRAINER_REGISTRY)}")
    return TRAINER_REGISTRY[name]
