"""Run one cell of the port's benchmark once and print its result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last the compared numbers beside their limits under
``checks``); everything else goes to standard error, which ends with the
compared numbers. Exits 1, printing no result, without the card(s), or
where a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread for BLAS and torch's CPU ops: the host's cores are shared,
# and fewer threads make set-up faster and runs steadier (the card does the work)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench import bench  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    import torch

    torch.set_num_threads(1)
    cell = bench.load("workloads", args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        bench.log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 1
    config = bench.load("configs", cell["config"])
    e2e, per_layer = bench.cell_metrics(bench.benchmark(), args.workload)
    traffic = bench.load("traffic", cell["traffic"])
    run = bench.Run(args.workload, cell, config, traffic, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), e2e, per_layer)
    run.t_start = T_START
    result = bench.run_cell(run)
    found = bench.forbidden_modules()
    if found:
        bench.log("modules of JAX or the JAX package were loaded:", ", ".join(found))
        return 1
    for name, c in result["checks"].items():
        bench.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
