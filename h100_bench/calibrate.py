"""Readings that the limits of ``correct`` are set from, on the card, at a
cell's own size: the program's compared numbers over many seeds, and the
control's (the reference computed in float8 e4m3, the precision below the
configuration's bf16, in the program's place) on some of them, all in one
process. A train cell can also plant the fault of half the batch left out
(the mean taken over the rest) in the program.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 2] [--fault half_batch] [--out FILE]

One JSON line per seed on standard output (and appended to ``--out``).
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from h100_bench import bench  # noqa: E402


def half_batch() -> None:
    """Plant the fault: every train step sees the first half of its batch."""
    from nextou_tpu_torch.train import train_step as ts

    whole = ts._batch_on

    def half(model, batch, augment=None):
        data, seg = whole(model, batch, augment)
        n = max(1, data.shape[0] // 2)
        return data[:n], seg[:n]

    ts._batch_on = half


def control(cell, mode: str) -> dict:
    """The control's compared numbers against the float32 reference."""
    if mode == "train":
        return cell.gaps(cell.reference_readings("fp8"), cell.ref)
    import torch

    from h100_bench.reference import sliding

    fp8 = cell.reference_net("fp8")
    labels = []
    for i, _ in cell.sample():
        vol = torch.from_numpy(cell.pool[i]).to(cell.run.device)
        probs = sliding.predict_probs(fp8, vol, cell.patch, cell.mirror_axes)
        labels.append((i, probs.argmax(-1).to(torch.uint8).cpu().numpy()))
    return cell.gaps(cell.ref, labels)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", choices=("half_batch",), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench.set_cache_dirs()
    import importlib

    import torch

    if not torch.cuda.is_available():
        bench.log("calibrate: no CUDA card visible")
        return 1
    if args.fault == "half_batch":
        half_batch()
    cell_def = bench.load("workloads", args.workload)
    config = bench.load("configs", cell_def["config"])
    traffic = bench.load("traffic", cell_def["traffic"])
    mode = importlib.import_module(f"h100_bench.modes.{cell_def['mode']}")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = bench.Run(args.workload, cell_def, config, traffic, seed, args.seconds, False,
                        torch.device("cuda", 0), [], {})
        cell = mode.Cell(run)
        cell.setup()
        setup_s = time.perf_counter() - t0
        cell.window(args.seconds)
        cell.release()
        try:
            cell.check()
            record = {"workload": args.workload, "seed": seed, "fault": args.fault,
                      "setup_s": setup_s, "program": cell.last_gaps}
            if seed in controls:
                record["control"] = control(cell, cell_def["mode"])
        finally:
            cell.close()
        record["seconds"] = time.perf_counter() - t0
        line = json.dumps(record)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del cell, run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
