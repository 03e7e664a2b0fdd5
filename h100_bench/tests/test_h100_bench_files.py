"""BENCHMARK.json and the files it names: every cell, configuration, traffic,
metric and kernel group resolves by name, names and units keep to their
characters, and a cell or a metric added as files alone is picked up."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

from h100_bench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source", "workloads"},
    "layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
}


def test_benchmark_resolves_by_name():
    b = bench.benchmark()
    assert set(b) == KEYS["top"]
    assert b["command"] == ["python3", "h100_bench/run.py"] and b["paths"] == ["h100_bench"]
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) <= KEYS["config"] and NAME.match(c["name"])
        cfg = bench.load("configs", c["name"])
        assert c["file"] == f"h100_bench/configs/{c['name']}.json"
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert all(NAME.match(k) and k in cfg for k in c["reduced"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= KEYS["e2e"] and NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert set(w) == KEYS["workload"] and NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["config"] in configs and w["chips"] == 1
        cell = bench.load("workloads", w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == (w["config"], w["traffic"], 1)
        bench.load("traffic", w["traffic"])
        import importlib

        importlib.import_module(f"h100_bench.modes.{cell['mode']}")
        reported = bench.cell_metrics(b, w["name"])
        assert "setup_s" in dict(reported[0]) and len(reported[0]) >= 2 and reported[1]
    table = bench.groups()
    for m in b["per_layer"]:
        assert set(m) <= KEYS["layer"] and NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in dict(bench.cell_metrics(b, cell)[0])
        spec = bench.load("metrics", m["name"])
        importlib.import_module(f"h100_bench.readers.{spec['reader']}")
        assert set(spec.get("groups", [])) <= set(table)
    for group in ("k1", "k3", "k4", "k5", "conv_cudnn", "layout", "norm", "optimizer"):
        assert table[group]


def test_longest_fragment_wins():
    table = bench.groups()
    assert bench.group_of("conv_sm90_kernel<128>", table) == "k5"
    assert bench.group_of("void knn_max_kernel<true>", table) == "k1"
    assert bench.group_of("cudnn::engines_precompiled::nchwToNhwcKernel", table) == "layout"
    assert bench.group_of("no such kernel", table) is None


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    shutil.copytree(bench.BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = bench.benchmark()
    new_cell = dict(bench.load("workloads", "btcv3d_serve"), why="a second serving pool")
    (tmp_path / "h100_bench/workloads/btcv3d_serve_b.json").write_text(json.dumps(new_cell))
    (tmp_path / "h100_bench/metrics/k1_ms.serve.json").write_text(
        json.dumps({"reader": "group_ms", "groups": ["k1"], "per": "forward"}))
    (tmp_path / "h100_bench/groups/k1/renamed.txt").write_text("knn_max_v2_kernel\n")
    b["workloads"].append({"name": "btcv3d_serve_b", "config": "nextou_3d_btcv",
                           "traffic": "btcv_cases", "chips": 1, "why": "a second pool"})
    for m in b["end_to_end"]:
        if "btcv3d_serve" in m.get("workloads", []):
            m["workloads"].append("btcv3d_serve_b")
    b["per_layer"].append({"name": "k1_ms.serve", "unit": "ms/forward", "better": "lower",
                           "source": "device_trace", "layer": "graphers and kNN",
                           "moves": "serve_mvox_per_s", "workloads": ["btcv3d_serve_b"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "from h100_bench import bench; b = bench.benchmark();"
        "e2e, layer = bench.cell_metrics(b, 'btcv3d_serve_b');"
        "print(bench.load('workloads', 'btcv3d_serve_b')['mode'], sorted(dict(e2e)), sorted(layer),"
        " bench.load('metrics', 'k1_ms.serve')['reader'],"
        " bench.group_of('knn_max_v2_kernel', bench.groups()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout
    assert out.startswith("serve ['serve_mvox_per_s', 'setup_s'] ['k1_ms.serve']")
    assert out.strip().endswith("group_ms k1")
