"""The benchmark's core: cells, configurations, metrics and kernel groups
found by name in their own files, one run of a cell, the profiled stretch,
and the result line.

A run: set-up (imports, kernels, weights, data, warm-up; the mode splits
it), the measured window, with ``trace`` a profiled stretch after the
window, the peak memory, then the mode frees the program's state and runs
its comparison with the reference. Modes live in ``modes/<mode>.py`` and
expose ``Cell(run)`` with ``setup()``, ``unit()`` (one step or request),
``window(seconds)``, ``after_trace()``, ``release()``, ``check()`` (the
compared numbers with their limits) and ``close()``.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nextou_tpu")


def load(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` of the benchmark: a config, workload or metric."""
    path = BENCH / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def groups() -> dict[str, list[str]]:
    """Kernel group -> name fragments: every line of every ``.txt`` file
    under ``groups/<group>/``."""
    out: dict[str, list[str]] = {}
    for d in sorted(p for p in (BENCH / "groups").iterdir() if p.is_dir()):
        frags = []
        for f in sorted(d.glob("*.txt")):
            frags += [ln.strip() for ln in f.read_text().splitlines()
                      if ln.strip() and not ln.startswith("#")]
        out[d.name] = frags
    return out


def group_of(name: str, table: dict[str, list[str]]) -> str | None:
    """The group whose longest fragment is in ``name``: the most specific
    match wins, whatever order the groups are read in."""
    best, length = None, 0
    for g, frags in table.items():
        for frag in frags:
            if frag in name and len(frag) > length:
                best, length = g, len(frag)
    return best


def forbidden_modules(names=None) -> list[str]:
    """Of ``names`` (default: the loaded modules), those whose top-level name,
    compared whole, is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules if names is None else names)
                  if m.split(".")[0] in FORBIDDEN)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Profile:
    """Device activity of a profiled stretch: kernel seconds by name, busy
    seconds (the union of device intervals), the stretch's wall seconds, and
    the idle gaps named by the host operation that overlapped each most."""

    def __init__(self, prof, wall_s: float, units: int):
        dev, host = [], []
        for e in prof.events():
            t0, t1 = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((t0, t1, e.name))
            else:
                host.append((t0, t1, e.name))
        if not dev:
            raise RuntimeError("the profiler recorded no device operation")
        self.units, self.window_s = units, wall_s
        self.by_name: dict[str, float] = {}
        for t0, t1, name in dev:
            self.by_name[name] = self.by_name.get(name, 0.0) + (t1 - t0) / 1e6
        dev.sort()
        merged = []
        for t0, t1, _ in dev:
            if merged and t0 <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t1)
            else:
                merged.append([t0, t1])
        self.busy_s = sum(t1 - t0 for t0, t1 in merged) / 1e6
        gaps = sorted(((a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]),
                      key=lambda g: g[0] - g[1])
        h0 = np.array([h[0] for h in host], np.float64)
        h1 = np.array([h[1] for h in host], np.float64)
        named: dict[str, float] = {}
        for g0, g1 in gaps[:500]:  # the longest gaps, named by the host's work then
            overlap = np.minimum(g1, h1) - np.maximum(g0, h0)
            # the most overlap; among equals, the shortest (innermost) host operation
            i = np.lexsort((h1 - h0, -overlap))[0] if len(host) else -1
            name = host[i][2] if i >= 0 and overlap[i] > 0 else "no host operation"
            named[name] = named.get(name, 0.0) + (g1 - g0) / 1e6
        self.idle_gaps = sorted(named.items(), key=lambda kv: -kv[1])[:10]

    def group_s(self, table) -> dict[str, float]:
        out: dict[str, float] = {}
        for name, s in self.by_name.items():
            g = group_of(name, table) or "unmatched"
            out[g] = out.get(g, 0.0) + s
        return out


class Run:
    """One run of one cell: its files, arguments, device and what the run
    measured, for the mode and the metric readers."""

    def __init__(self, cell_name: str, cell: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device: torch.device, end_to_end: list,
                 per_layer: dict[str, dict]):
        self.cell_name, self.cell, self.config, self.traffic = cell_name, cell, config, traffic
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.end_to_end, self.per_layer = end_to_end, per_layer
        self.setup_parts: dict[str, float] = {}
        self.stats: dict[str, float] = {}
        self.profile: Profile | None = None
        self.attempted = self.failed = 0
        self.t_start = time.perf_counter()

    def part(self, name: str, t0: float) -> float:
        """Record ``now - t0`` as the set-up part ``name``; return now."""
        now = time.perf_counter()
        self.setup_parts[name] = self.setup_parts.get(name, 0.0) + now - t0
        return now

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def profiled(self, unit, n: int) -> Profile:
        """``n`` calls of ``unit`` under ``torch.profiler`` (one session)."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            self.sync()
            t0 = time.perf_counter()
            for _ in range(n):
                unit()
            self.sync()
            wall = time.perf_counter() - t0
        return Profile(prof, wall, n)


def run_cell(run: Run) -> dict:
    """Run one cell; returns the result line's object (without printing)."""
    mode = importlib.import_module(f"h100_bench.modes.{run.cell['mode']}")
    cell = mode.Cell(run)
    cell.setup()
    run.sync()
    setup_s = time.perf_counter() - run.t_start
    log("setup_s", f"{setup_s:.3f}", json.dumps(run.setup_parts))
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    e2e = cell.window(run.seconds)
    e2e["setup_s"] = setup_s
    if run.trace:
        run.profile = run.profiled(cell.unit, int(run.cell["trace_units"]))
        cell.after_trace()
    peak = torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda" else 0
    run.stats["peak_gib"] = peak / 2**30
    cell.release()
    try:
        checks = cell.check()
    finally:
        cell.close()
    metrics = {}
    if run.trace:
        for name, meta in run.per_layer.items():
            spec = load("metrics", name)
            reader = importlib.import_module(f"h100_bench.readers.{spec['reader']}")
            value = reader.read(run, spec)
            if value is not None:
                metrics[name] = {"value": value, "unit": meta["unit"]}
        table = groups()
        by_group = run.profile.group_s(table)
        log("device seconds by group over", run.profile.units, "units:",
            json.dumps(dict(sorted(by_group.items(), key=lambda kv: -kv[1]))))
        unmatched = {n: s for n, s in run.profile.by_name.items() if group_of(n, table) is None}
        log("device seconds that matched no group:", sum(unmatched.values()), json.dumps(
            dict(sorted(unmatched.items(), key=lambda kv: -kv[1])[:15])))
    else:
        metrics = {name: {"value": e2e[name], "unit": unit}
                   for name, unit in run.end_to_end if name in e2e}
    correct = all(v <= limit for _, v, limit in checks) and run.failed == 0
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
              else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": device}
    if run.trace:
        p = run.profile
        device["busy_s"], device["window_s"] = p.busy_s, p.window_s
        top = sorted(p.by_name.items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n, s] for n, s in top],
                               "idle_gaps": [[n, s] for n, s in p.idle_gaps]}
    result["checks"] = {name: {"value": v, "limit": limit} for name, v, limit in checks}
    return result


def cell_metrics(bench: dict, cell_name: str) -> tuple[list, dict]:
    """The cell's end-to-end ``[(name, unit)]`` and per-layer ``{name: meta}``
    as ``BENCHMARK.json`` lists them."""
    def has(m):
        return "workloads" not in m or cell_name in m["workloads"]

    e2e = [(m["name"], m["unit"]) for m in bench["end_to_end"] if has(m)]
    per_layer = {m["name"]: m for m in bench["per_layer"] if has(m)}
    return e2e, per_layer


def set_cache_dirs() -> None:
    """Every build and kernel cache in fixed folders of the checkout."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
