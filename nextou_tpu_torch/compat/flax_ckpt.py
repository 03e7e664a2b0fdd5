"""Read ``nextou_tpu`` ``.ckpt`` checkpoints without jax, flax or msgpack.

A ``.ckpt`` (``nextou_tpu/train/checkpoint.py``) is a pickle (protocol 4) of
``{"state_bytes": bytes, "extra": plain values}``; ``state_bytes`` is flax's
msgpack encoding of the train state's dict: ``step``, ``params``,
``batch_stats``, ``constants``, ``opt_state``, ``rng``. This module reads
both layers itself:

- the pickle through :class:`RestrictedUnpickler`, which resolves a few
  builtins and numpy's array reconstruction and refuses every other global
  (a pickle naming one could run any code);
- the msgpack through :func:`msgpack_restore`, a decoder of the subset flax
  writes: maps, arrays, str, bin, ints, floats, nil and bools, and the ext
  types 1 (an ndarray) and 3 (a numpy scalar), each a nested msgpack triple
  ``(shape, dtype name, C-order bytes)``; arrays flax splits into
  ``__msgpack_chunked_array__`` chunks are joined again. An unknown type
  byte, ext code or dtype raises: nothing is guessed.

:func:`read_ckpt` returns the network's ``params``, ``batch_stats`` and
``constants`` trees as numpy, which
:func:`~nextou_tpu_torch.compat.weights.variables_to_state_dict` maps onto
the port's weights, and the ``extra`` dict. Only the network is read:
resuming training (``--c``) from a ``.ckpt`` is not supported, since the
optimizer state's layout (optax's) is not the port's.
"""

from __future__ import annotations

import pickle
import struct

import numpy as np
import torch

# ext codes of flax.serialization._MsgpackExtType
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"

# the globals a .ckpt's pickle may name: plain containers, and numpy's
# reconstruction of an array or scalar in its extra values
_ALLOWED_GLOBALS = {
    ("builtins", name) for name in (
        "set", "frozenset", "complex", "slice", "range", "bytearray", "list", "dict",
        "tuple", "int", "float", "str", "bytes", "bool")
} | {
    (mod, name)
    for mod in ("numpy.core.multiarray", "numpy._core.multiarray")
    for name in ("_reconstruct", "scalar")
} | {("numpy", "ndarray"), ("numpy", "dtype")}


class RestrictedUnpickler(pickle.Unpickler):
    """An unpickler that resolves only :data:`_ALLOWED_GLOBALS`."""

    def find_class(self, module: str, name: str):
        if (module, name) not in _ALLOWED_GLOBALS:
            raise pickle.UnpicklingError(f"a checkpoint may not name the global {module}.{name}")
        return super().find_class(module, name)


def _dtype(name: str) -> np.dtype:
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"unknown array dtype {name!r} in the checkpoint") from None
    if dtype.kind not in "biuf" or dtype.name != name:
        raise ValueError(f"unsupported array dtype {name!r} in the checkpoint")
    return dtype


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = msgpack_restore(payload, raw=True)
    name, shape = dtype_name.decode(), tuple(shape)
    if name == "bfloat16":  # numpy has none: read as torch's and widen to f32
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).float().numpy().reshape(shape)
    return np.frombuffer(buf, dtype=_dtype(name)).reshape(shape).copy()


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack("b")
        payload = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        raise ValueError(f"unknown msgpack ext code {code}")

    def value(self):
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map_(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {  # type byte -> (length format, reader)
            0xC4: ("B", self.take), 0xC5: ("H", self.take), 0xC6: ("I", self.take),
            0xC7: ("B", self.ext), 0xC8: ("H", self.ext), 0xC9: ("I", self.ext),
            0xD9: ("B", self.str_), 0xDA: ("H", self.str_), 0xDB: ("I", self.str_),
            0xDC: ("H", self.array), 0xDD: ("I", self.array),
            0xDE: ("H", self.map_), 0xDF: ("I", self.map_),
        }
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unchunk(tree):
    """Join flax's chunked arrays again (``serialization._unchunk``)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes, raw: bool = False):
    """Decode flax msgpack bytes (``flax.serialization.msgpack_restore``):
    a tree of dicts, lists and numpy arrays. ``raw`` leaves strings as bytes."""
    reader = _Reader(data, raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack value")
    return _unchunk(out)


def read_ckpt(path: str) -> tuple[dict, dict]:
    """``(variables, extra)`` of a ``nextou_tpu`` ``.ckpt``: the network's
    ``{'params', 'batch_stats', 'constants'}`` trees as numpy, and the
    trainer's plain ``extra`` values."""
    with open(path, "rb") as f:
        payload = RestrictedUnpickler(f).load()
    if not isinstance(payload, dict) or "state_bytes" not in payload:
        raise ValueError(f"{path} is not a nextou_tpu checkpoint")
    state = msgpack_restore(payload["state_bytes"])
    variables = {k: state.get(k) or {} for k in ("params", "batch_stats", "constants")}
    return variables, payload.get("extra", {})
