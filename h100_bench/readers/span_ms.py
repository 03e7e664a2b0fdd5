"""Milliseconds of the program's own spans per step, forward or case, from
the profiled stretch's record (``nextou_tpu_torch.trace.session()``):
``{"spans": [...], "clock": "device" | "host", "self": bool, "per": "step" |
"forward" | "case"}``. ``spans`` are names or ``fnmatch`` patterns
(``gnn.*``); a matched span inside another matched one is counted with it,
not again. ``self`` takes each span's time less its child spans'. Divided
by the profiled units (steps or cases), times ``forwards_per_unit`` for
``per: forward``. Nothing where the program records no spans, none matched,
a clock was not read, or the record's unit roots are not the profiled
units."""

from __future__ import annotations

from fnmatch import fnmatchcase


def value(session: dict, spec: dict, units: int, forwards_per_unit: int = 1) -> float | None:
    spans = session["spans"]
    if sum(1 for s in spans if s["root"]) != units or units <= 0:
        return None
    key = "device_ms" if spec["clock"] == "device" else "host_ms"

    def matches(s):
        return any(fnmatchcase(s["name"], p) for p in spec["spans"])

    def inside_a_match(s):
        p = s["parent"]
        while p is not None:
            if matches(spans[p]):
                return True
            p = spans[p]["parent"]
        return False

    children: dict[int, list[dict]] = {}
    for s in spans:
        if s["parent"] is not None:
            children.setdefault(s["parent"], []).append(s)
    total, found = 0.0, False
    for i, s in enumerate(spans):
        if not matches(s) or inside_a_match(s):
            continue
        ms = s[key]
        if ms is None:
            return None
        if spec.get("self"):
            kids = [c[key] for c in children.get(i, [])]
            if any(k is None for k in kids):
                return None
            ms -= sum(kids)
        total, found = total + ms, True
    if not found:
        return None
    per = units * (forwards_per_unit if spec["per"] == "forward" else 1)
    return total / per


def read(run, spec):
    try:
        from nextou_tpu_torch import trace
    except ImportError:  # a version of the program without spans
        return None
    return value(trace.session(), spec, run.profile.units,
                 int(run.stats.get("forwards_per_unit", 1)))
