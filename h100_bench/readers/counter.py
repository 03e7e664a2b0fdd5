"""One of the program's counters (``nextou_tpu_torch.trace.counters()``),
its total over the run, times a scale: ``{"counter": name, "scale": x}``.
Nothing where the program has no such counter."""

from __future__ import annotations


def value(counters: dict, spec: dict) -> float | None:
    n = counters.get(spec["counter"])
    return None if n is None else n * float(spec.get("scale", 1.0))


def read(run, spec):
    try:
        from nextou_tpu_torch import trace
    except ImportError:  # a version of the program without counters
        return None
    return value(trace.counters(), spec)
