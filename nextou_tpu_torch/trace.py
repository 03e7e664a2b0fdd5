"""Spans and counters of the port: where a train step's and a served case's
time goes, measured where the work happens.

Counters are always on: :func:`count` adds an integer to one registry of
the process and :func:`counters` copies it (``k1.launches`` ...
``k5.launches``, ``all_reduce.calls``, ``setup.tables_ns``).

Spans record only while a ``torch.profiler`` session is on in the calling
thread; that session is the switch, there is no other. Off, :func:`span`
returns one shared object whose ``with`` does nothing: no profiler range,
no CUDA event, no autograd node, no allocation. On, a span records its
name, its parent (the innermost open span of its thread, or on a thread
with none open, such as autograd's device thread, that of the thread that
opened the current unit), its thread, the id of its unit (the spans of one
train step or one served case share it), its start and end on
``time.time_ns()`` (the profiler's own clock) and a CUDA event on the
current stream at each end. It also opens a profiler range of its name, so
that it shows among the host operations of the profiler's timeline and of
any Chrome trace exported from it: a host operation
(``_RecordFunctionFast``), not ``record_function``'s user annotation, for
which the profiler would also record a device-side range over the span's
kernels, device activity that covers the idle time between them. A new
profiler session starts a new record; :func:`session` gives the last one,
with the CUDA events resolved and the counters' increase over the session.
"""

from __future__ import annotations

import threading
import time

import torch
from torch.autograd import profiler as _profiler

_lock = threading.Lock()
_counters: dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    """A copy of every counter's total since the process started."""
    with _lock:
        return dict(_counters)


class _Session:
    """What one profiler session recorded."""

    def __init__(self):
        self.spans: list[_Span] = []
        self.counters_at_start = counters()
        self.counters: dict[str, int] | None = None  # the increase, once stopped
        self.units = 0
        self.unit: int | None = None  # the open unit's id
        self.unit_stack: list[int] = []  # the open spans of the unit's thread


_session = _Session()
_local = threading.local()


_enabled = torch._C._autograd._profiler_enabled
_range = torch._C._profiler._RecordFunctionFast


def on() -> bool:
    """True while a profiler session is on in the calling thread."""
    return _profiler._is_profiler_enabled and _enabled()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "thread", "unit", "root", "start_ns", "end_ns", "events",
                 "_stack", "_index", "_record", "_session")

    def __init__(self, name: str, root: bool):
        self.name, self.root = name, root

    def __enter__(self):
        s = _session
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if self.root:
            s.unit, s.unit_stack = s.units, stack
            s.units += 1
        # on a thread with no open span, the unit's thread's innermost one
        parent = (stack or s.unit_stack)[-1:]
        self.parent = parent[0] if parent else None
        self.thread, self.unit = threading.get_ident(), s.unit
        self._session, self._stack, self._index = s, stack, len(s.spans)
        s.spans.append(self)
        stack.append(self._index)
        self.end_ns = None
        self.start_ns = time.time_ns()
        self._record = _range(self.name)
        self._record.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record()
        self._record.__exit__(None, None, None)
        self.end_ns = time.time_ns()
        if self._index in self._stack:
            self._stack.remove(self._index)
        if self.root and self._session.unit == self.unit:
            self._session.unit = None
        return False

    def as_dict(self) -> dict:
        device_ms = None
        if self.events is not None and self.end_ns is not None:
            device_ms = self.events[0].elapsed_time(self.events[1])
        host_ms = None if self.end_ns is None else (self.end_ns - self.start_ns) / 1e6
        return {"name": self.name, "parent": self.parent, "thread": self.thread,
                "unit": self.unit, "root": self.root, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "host_ms": host_ms, "device_ms": device_ms}


def span(name: str, *, unit: bool = False):
    """A context manager that records the span ``name`` while tracing is on
    (see the module's docstring) and does nothing otherwise. ``unit`` marks
    the root of one unit of work (a train step, a served case): it and every
    span opened until it closes share the unit's id."""
    if not on():
        return _OFF
    return _Span(name, unit)


class _CloseInBackward(torch.autograd.Function):
    """Identity at a block's input: its backward runs once the block's
    backward is done, and closes the block's backward span."""

    @staticmethod
    def forward(ctx, x, opened: list):
        ctx.opened = opened
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.opened:
            ctx.opened.pop().__exit__(None, None, None)
        return g, None


class _OpenInBackward(torch.autograd.Function):
    """Identity at a block's output: its backward runs before the block's
    and opens the block's backward span, after the recompute of a stage
    under ``torch.utils.checkpoint`` (unpacking its saved placeholder
    starts the recompute), so that the span holds the block's backward
    alone."""

    @staticmethod
    def forward(ctx, x, name: str, opened: list):
        ctx.name, ctx.opened = name, opened
        ctx.save_for_backward(x.new_empty(0))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.saved_tensors  # noqa: B018 (the recompute, where there is one)
        s = span(ctx.name)
        if s is not _OFF:
            ctx.opened.append(s.__enter__())
        return g, None, None


def block(name: str, fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` in the span ``name``; with a gradient to come, the same
    span again around the block's backward pass (two identity autograd
    nodes at its input and output open and close it). Call only while
    :func:`on`: off, call ``fn(x)`` itself, so that nothing is inserted."""
    with span(name):
        if not (torch.is_grad_enabled() and x.requires_grad):
            return fn(x)
        opened: list = []
        y = fn(_CloseInBackward.apply(x, opened))
        return _OpenInBackward.apply(y, name, opened)


def session() -> dict:
    """The last profiler session's record: ``{"spans": [...], "counters":
    {...}}``. Each span is a dict with ``name``, ``parent`` (an index into
    ``spans``, or None), ``thread``, ``unit`` (None outside a unit),
    ``root`` (it opened its unit), ``start_ns``, ``end_ns`` (epoch ns, None
    while open), ``host_ms`` and ``device_ms`` (None without CUDA); spans
    come in the order they opened. ``counters`` is each counter's increase
    over the session (up to now while it runs). Waits for the device."""
    s = _session
    if any(sp.events is not None for sp in s.spans):
        torch.cuda.synchronize()
    grown = s.counters if s.counters is not None else _increase(s)
    return {"spans": [sp.as_dict() for sp in s.spans], "counters": dict(grown)}


def _increase(s: _Session) -> dict[str, int]:
    return {k: v - s.counters_at_start.get(k, 0) for k, v in counters().items()}


def _started():
    global _session
    _session = _Session()


def _stopped():
    if _session.counters is None:
        _session.counters = _increase(_session)


def _follow(name: str, hook) -> None:
    """Run ``hook`` after torch's own ``name`` (called as a profiler starts or
    stops, by every profiler torch has); once per process."""
    original = getattr(_profiler, name)
    if getattr(original, "_nextou_trace", False):
        return

    def wrapped():
        original()
        hook()

    wrapped._nextou_trace = True
    setattr(_profiler, name, wrapped)


_follow("_run_on_profiler_start", _started)
_follow("_run_on_profiler_stop", _stopped)
