"""What the harness loads: no module whose top-level name, compared whole,
is ``jax``, ``jaxlib``, ``flax`` or ``nextou_tpu`` (the port's name,
``nextou_tpu_torch``, begins with the JAX package's); and the reference
imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys

from h100_bench import bench

LOADS = ("h100_bench.bench", "h100_bench.modes.train", "h100_bench.modes.serve",
         "h100_bench.calibrate", "h100_bench.readers.group_ms", "h100_bench.readers.mfu",
         "h100_bench.readers.roofline_share", "h100_bench.readers.idle_share",
         "h100_bench.readers.stat", "nextou_tpu_torch.train", "nextou_tpu_torch.predict",
         "nextou_tpu_torch.kernels.build", "nextou_tpu_torch.data.device_augment")


def test_the_harness_loads_no_jax():
    code = ("import sys, importlib\n"
            f"for m in {LOADS!r}: importlib.import_module(m)\n"
            "from h100_bench import bench\n"
            "print(','.join(bench.forbidden_modules()) or 'none')\n"
            "print('nextou_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=bench.ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == ["none", "True"]


def test_whole_name_comparison():
    names = ["nextou_tpu_torch", "nextou_tpu_torch.kernels.knn", "jaxtyping", "flaxen",
             "nextou_tpu", "nextou_tpu.models", "jax.numpy", "jaxlib", "flax.linen"]
    assert bench.forbidden_modules(names) == ["flax.linen", "jax.numpy", "jaxlib", "nextou_tpu",
                                              "nextou_tpu.models"]


def test_reference_imports_nothing_of_the_program():
    for path in sorted((bench.BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in ("nextou_tpu_torch", "nextou_tpu", "jax",
                                                  "jaxlib", "flax"), (path.name, name)
