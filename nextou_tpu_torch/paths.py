"""Dataset folder resolution via nnU-Net's environment variables.

Counterpart of ``nextou_tpu/paths.py``. Upstream's CLIs address datasets by
name ("Dataset111_XXX") resolved against ``nnUNet_raw`` and
``nnUNet_preprocessed``; the port's CLIs do the same. These variables name
folders, they switch nothing. An explicit path that exists always wins.
"""

from __future__ import annotations

import os


def _resolve(arg: str, env_name: str) -> str:
    if os.path.exists(arg):
        return arg
    base = os.environ.get(env_name)
    if base:
        cand = os.path.join(base, arg)
        if os.path.exists(cand):
            return cand
    return arg


def resolve_preprocessed(arg: str) -> str:
    return _resolve(arg, "nnUNet_preprocessed")


def resolve_raw(arg: str) -> str:
    return _resolve(arg, "nnUNet_raw")
