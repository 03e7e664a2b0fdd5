"""CLI: import an upstream PyTorch NexToU checkpoint into a model folder.

Counterpart of ``nextou_tpu/import_torch_checkpoint.py``. Takes an nnU-Net
/ NexToU torch checkpoint (``checkpoint_final.pth`` / ``checkpoint_best.pth``
with ``network_weights``, or a raw ``state_dict``), strips DDP's ``module.``
and ``torch.compile``'s ``_orig_mod.`` prefixes and the alias entries
(:func:`~nextou_tpu_torch.compat.weights.extract_network_weights`), loads it
strictly into the network the trainer builds from the plans (a missing or
an extra tensor raises), and writes the port's checkpoint:

    python -m nextou_tpu_torch.import_torch_checkpoint CKPT.pth DATASET_FOLDER \\
        CONFIG [-tr TRAINER] [-p plans.json] -o OUT_FOLDER [--device cuda]

OUT_FOLDER becomes a model folder (``checkpoint_final.pth``, ``plans.json``,
``dataset.json``) that ``python -m nextou_tpu_torch.predict`` serves, raw
volumes included. The network is built on the card unless ``--device cpu``
asks for the CPU; without a card and without that option it fails.

The checkpoint is read with ``torch.load(weights_only=True)``; a file that
needs full unpickling (arbitrary code) loads only with
``--trust-checkpoint``.
"""

from __future__ import annotations

import argparse
import os

import torch

from nextou_tpu_torch.compat.weights import extract_network_weights
from nextou_tpu_torch.paths import resolve_preprocessed
from nextou_tpu_torch.plans.loader import load_dataset_json
from nextou_tpu_torch.train import get_trainer_class
from nextou_tpu_torch.train.checkpoint import save_checkpoint


def main(argv=None):
    """Run the CLI; returns the path of the written checkpoint."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("torch_checkpoint")
    ap.add_argument("dataset_folder", help="preprocessed dataset folder")
    ap.add_argument("configuration", help="e.g. 3d_fullres_nextou")
    ap.add_argument("-tr", "--trainer", default="nnUNetTrainer_NexToU")
    ap.add_argument("-p", "--plans", default=None)
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument(
        "--trust-checkpoint",
        action="store_true",
        help="allow full (arbitrary-pickle) torch.load for checkpoints that "
        "weights_only loading rejects; only use on files you trust",
    )
    ap.add_argument("--device", default="cuda",
                    help="the card by default; 'cpu' builds the network on the CPU")
    args = ap.parse_args(argv)

    args.dataset_folder = resolve_preprocessed(args.dataset_folder)
    plans_path = args.plans or os.path.join(args.dataset_folder, "nnUNetPlans.json")
    dataset_json = load_dataset_json(args.dataset_folder)
    trainer = get_trainer_class(args.trainer)(
        plans_path,
        args.configuration,
        0,
        dataset_json,
        preprocessed_folder=args.dataset_folder,
        output_folder=args.output,
        device=args.device,
    ).initialize()

    try:
        ckpt = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=True)
    except Exception:
        # nnU-Net checkpoints pickle non-tensor objects (plans dicts etc.);
        # full unpickling executes arbitrary code, so it is opt-in
        if not args.trust_checkpoint:
            raise SystemExit(
                "checkpoint requires full pickle loading (arbitrary code "
                "execution risk); re-run with --trust-checkpoint if you "
                "trust this file"
            )
        ckpt = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=False)
    sd = extract_network_weights(ckpt)
    trainer.network.load_state_dict(sd, strict=True)

    extra = {
        "trainer": args.trainer,
        "configuration": args.configuration,
        "imported_from": os.path.abspath(args.torch_checkpoint),
    }
    if isinstance(ckpt, dict) and "current_epoch" in ckpt:
        extra["epoch"] = int(ckpt["current_epoch"])
    out_path = os.path.join(args.output, "checkpoint_final.pth")
    save_checkpoint(out_path, trainer.state, extra)
    n_params = sum(p.numel() for p in trainer.network.parameters())
    print(f"imported {len(sd)} tensors -> {out_path} ({n_params:,} params)")
    return out_path


if __name__ == "__main__":
    main()
