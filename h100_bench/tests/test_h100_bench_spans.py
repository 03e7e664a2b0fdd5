"""The readers of the program's spans and counters (``readers/span_ms.py``,
``readers/counter.py``) on a synthetic session: sums, self time, nested
matches counted once, the division per step or forward, and nothing where
the units disagree, nothing matched or a clock was not read; and every
metric file that names them."""

from __future__ import annotations

import types

import pytest

from h100_bench import bench
from h100_bench.readers import counter, span_ms


def _span(name, parent=None, device=None, host=None, root=False):
    return {"name": name, "parent": parent, "thread": 1, "unit": 0, "root": root,
            "start_ns": 0, "end_ns": 1, "host_ms": host, "device_ms": device}


def _session():
    spans = []
    for u in range(2):
        r = len(spans)
        spans += [
            _span("train.step", device=100.0, host=90.0, root=True),
            _span("train.forward", r, device=40.0, host=5.0),
            _span("gnn.enc2.0", r + 1, device=10.0),
            _span("gnn.enc2.1", r + 1, device=6.0),
            _span("train.backward", r, device=50.0, host=1.0),
            _span("gnn.enc2.1", r + 4, device=12.0),  # a recompute inside a block's span
            _span("gnn.enc2.0", r + 5, device=3.0),
        ]
    spans.append(_span("loader.next", host=7.0))
    return {"spans": spans, "counters": {}}


def test_sums_per_step_and_per_forward():
    s = _session()
    spec = {"spans": ["train.forward"], "clock": "device", "self": False, "per": "step"}
    assert span_ms.value(s, spec, 2) == 40.0
    assert span_ms.value(s, dict(spec, clock="host"), 2) == 5.0
    assert span_ms.value(s, dict(spec, per="forward"), 2, forwards_per_unit=4) == 10.0
    assert span_ms.value(s, dict(spec, spans=["loader.next"], clock="host"), 2) == 3.5
    # gnn.enc2.0 under gnn.enc2.1 is inside a match: counted with it, not again
    gnn = dict(spec, spans=["gnn.*"])
    assert span_ms.value(s, gnn, 2) == 10.0 + 6.0 + 12.0


def test_self_time_leaves_out_the_children():
    s = _session()
    spec = {"spans": ["train.forward"], "clock": "device", "self": True, "per": "step"}
    assert span_ms.value(s, spec, 2) == 40.0 - 16.0
    spec = dict(spec, spans=["train.step"])
    assert span_ms.value(s, spec, 2) == 100.0 - 90.0


def test_nothing_on_a_unit_mismatch_or_nothing_to_read():
    s = _session()
    spec = {"spans": ["train.forward"], "clock": "device", "self": False, "per": "step"}
    assert span_ms.value(s, spec, 3) is None
    assert span_ms.value(s, spec, 1) is None
    assert span_ms.value({"spans": [], "counters": {}}, spec, 0) is None
    assert span_ms.value(s, dict(spec, spans=["serve.forward"]), 2) is None
    assert span_ms.value(s, dict(spec, spans=["gnn.*"], clock="host"), 2) is None
    assert span_ms.value(s, dict(spec, clock="host", self=True), 2) is None


def test_counter_total_times_its_scale():
    spec = {"counter": "setup.tables_ns", "scale": 1e-9}
    assert counter.value({"setup.tables_ns": 2_500_000_000}, spec) == pytest.approx(2.5)
    assert counter.value({"k1.launches": 3}, spec) is None
    assert counter.value({"k1.launches": 3}, {"counter": "k1.launches"}) == 3


def test_readers_on_the_program_record():
    from nextou_tpu_torch import trace

    run = types.SimpleNamespace(profile=types.SimpleNamespace(units=0), stats={})
    trace.count("setup.tables_ns", 7)
    assert counter.read(run, {"counter": "setup.tables_ns", "scale": 1.0}) >= 7
    spec = {"spans": ["no.such.span"], "clock": "host", "self": False, "per": "step"}
    assert span_ms.read(run, spec) is None


def test_metric_files_name_the_readers_soundly():
    b = bench.benchmark()
    layer = {m["name"]: m for m in b["per_layer"]}
    for name, m in layer.items():
        spec = bench.load("metrics", name)
        if spec["reader"] == "span_ms":
            assert m["source"] == "program_span" and spec["clock"] in ("device", "host")
            assert spec["per"] in ("step", "forward", "case") and spec["spans"]
            assert m["unit"] == {"step": "ms/step", "forward": "ms/forward",
                                 "case": "ms/case"}[spec["per"]]
        elif spec["reader"] == "counter":
            assert m["source"] == "program_counter" and spec["counter"]
