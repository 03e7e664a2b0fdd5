"""The trainer loop at a real epoch's length, host against device
augmentation, over loader threads, on a CUDA card.

    python -m nextou_tpu_torch.tools.exp_trainer_loop [--iters 250] [--threads 2 4 8] [--json PATH]

The flagship ``3d_fullres_nextou`` (``nnUNetTrainer_NexToU``, seed-0
weights, batch 2, bf16) trains one epoch of ``--iters`` iterations on the
five labelled 1x64x280x240 cases of ``chip_smoke.py``'s phase 14 (fold 0),
with 2 validation iterations and no final validation, once per loader
thread count and ``device_da`` off and on, after the kernels' build and a
warm-up run of 4 iterations that no row counts. Each run prints the seconds per
iteration (the trainer's own clock, losses read once per epoch), the share
of the loop spent waiting in ``next(train_it)``, and then the loader alone:
seconds per batch over 8 batches once its queue has drained (host mode:
sampling and augmentation; device mode: sampling and the plans). Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from nextou_tpu_torch.tools.synthetic import write_dataset
from nextou_tpu_torch.tools.timing import card, require_card

CONFIG, CASES, SHAPE, VAL_ITERS, LOADER_BATCHES = "3d_fullres_nextou", 5, (64, 280, 240), 2, 8
WARMUP_ITERS = 4


def loader_seconds_per_batch(loader) -> float:
    """Seconds per batch of ``loader`` alone once its prefetch queue has
    drained."""
    with loader:
        it = iter(loader)
        for _ in range(loader.prefetch + 1):
            next(it)
        t0 = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            next(it)
        return (time.perf_counter() - t0) / LOADER_BATCHES


def run(data_dir: str, out_dir: str, threads: int, device_da: bool, iters: int,
        device: str = "cuda") -> dict:
    """One epoch of ``iters`` iterations of the flagship trainer on the
    dataset at ``data_dir``, then its loader alone."""
    from nextou_tpu_torch.plans import load_dataset_json
    from nextou_tpu_torch.train import get_trainer_class

    trainer = get_trainer_class("nnUNetTrainer_NexToU")(
        os.path.join(data_dir, "nnUNetPlans.json"), CONFIG, 0, load_dataset_json(data_dir),
        preprocessed_folder=data_dir, output_folder=out_dir, device=device, seed=0,
        device_da=device_da, loader_threads=threads, num_epochs=1,
        num_iterations_per_epoch=iters)
    trainer.num_val_iterations_per_epoch = VAL_ITERS
    trainer.run_training()
    (entry,) = trainer.log_history
    loader, _ = trainer.get_dataloaders()
    return {"threads": threads, "device_da": device_da, "iterations": iters,
            "s_per_iter": entry["train_time_s"] / iters,
            "wait_share": entry["loader_wait_s"] / entry["train_time_s"],
            "train_loss": entry["train_loss"], "loader_s_per_batch": loader_seconds_per_batch(loader)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=250, help="iterations of the one epoch")
    ap.add_argument("--threads", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--json", default=None, help="also write the rows to this file")
    args = ap.parse_args(argv)
    if not require_card("exp_trainer_loop"):
        return 1
    from nextou_tpu_torch.kernels.build import build_kernels
    from nextou_tpu_torch.models.presets import flagship_3d_spec

    smi = card()
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"os.cpu_count() {os.cpu_count()}")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        data_dir = os.path.join(tmp, "data")
        write_dataset(data_dir, flagship_3d_spec(num_classes=14), CONFIG, CASES, SHAPE, seed=50,
                      labelled=True)
        # the kernels' build and the first steps' warm-up, outside every row
        build_kernels()
        run(data_dir, os.path.join(tmp, "warmup"), 2, True, WARMUP_ITERS)
        for threads in args.threads:
            for device_da in (False, True):
                row = run(data_dir, os.path.join(tmp, f"out_{threads}_{device_da}"), threads,
                          device_da, args.iters)
                rows.append(row)
                print(f"threads {threads}, device_da {'on' if device_da else 'off'}: "
                      f"{row['s_per_iter']:.4f} s per iteration over {args.iters}, loader wait "
                      f"{row['wait_share']:.4f} of the loop, loader alone "
                      f"{row['loader_s_per_batch']:.4f} s per batch, train loss "
                      f"{row['train_loss']:.4f}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)
    print(smi)
    print(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
