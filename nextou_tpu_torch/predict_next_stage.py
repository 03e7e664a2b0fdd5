"""CLI: the next cascade stage's inputs from a trained lowres model,
counterpart of ``nextou_tpu/predict_next_stage.py`` (nnU-Net's cascade step).

The lowres model predicts every training case with sliding-window inference
(the trainer's TTA), its argmax is resampled by order 0 onto the next
configuration's preprocessed grid with that configuration's seg-resampling
kwargs (``data/resampling.py``), and the result is stored where the cascade
trainer looks for it: ``<preprocessed>/predicted_next_stage/<config>/{case}.npz``
with ``seg`` int16.

    python -m nextou_tpu_torch.predict_next_stage PREPROCESSED_FOLDER MODEL_FOLDER \\
        [-c 3d_lowres] [--next 3d_cascade_fullres] [-tr nnUNetTrainer]
        [-chk checkpoint_final.pth] [-f 0 1 2 3 4] [--device cpu]

With ``-f`` each fold's checkpoint predicts that fold's validation cases
(out of fold, nnU-Net's semantics); without it the one checkpoint predicts
every case, its own training cases in fold (a warning says so). Runs on the
card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from nextou_tpu_torch.data.dataset import PreprocessedDataset
from nextou_tpu_torch.data.resampling import resample_data_or_seg_to_shape
from nextou_tpu_torch.predict import (
    _fold_model_folders,
    build_predictor,
    build_spec,
    load_model,
    mirror_axes_for,
)
from nextou_tpu_torch.plans.loader import PlansManager, load_dataset_json


def main(argv=None) -> str:
    """Run the CLI; returns the output folder."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset_folder", help="preprocessed dataset folder")
    ap.add_argument("model_folder", help="trained lowres model folder")
    ap.add_argument("-c", "--configuration", default="3d_lowres")
    ap.add_argument("--next", dest="next_config", default="3d_fullres",
                    help="configuration whose grid to resample onto")
    ap.add_argument("-tr", "--trainer", default="nnUNetTrainer_NexToU")
    ap.add_argument("-chk", default="checkpoint_final.pth",
                    help="a torch .pth or a nextou_tpu .ckpt")
    ap.add_argument("--tile-batch", type=int, default=2)
    ap.add_argument("-f", "--folds", nargs="*", default=None,
                    help="predict each fold's validation cases with that fold's checkpoint "
                         "(out of fold; the five folds cover every training case)")
    ap.add_argument("--device", default="cuda",
                    help="the card by default; 'cpu' computes on the CPU in f32")
    args = ap.parse_args(argv)

    from nextou_tpu_torch.train import get_trainer_class

    device = torch.device(args.device)
    dataset_json = load_dataset_json(args.dataset_folder)
    plans_path = os.path.join(args.dataset_folder, "nnUNetPlans.json")
    plans = PlansManager(plans_path)
    cm, next_cm = (plans.get_configuration(c) for c in (args.configuration, args.next_config))
    labels = plans.get_label_manager(dataset_json)
    spec = build_spec(plans, args.configuration, dataset_json, args.trainer)
    mirror = mirror_axes_for(args.trainer, spec.spatial_dims)

    def data_dir(config_cm, name: str) -> str:
        sub = os.path.join(args.dataset_folder, config_cm.data_identifier or name)
        return sub if os.path.isdir(sub) else args.dataset_folder

    src = PreprocessedDataset(data_dir(cm, args.configuration))
    dst_dir = data_dir(next_cm, args.next_config)
    out_dir = os.path.join(args.dataset_folder, "predicted_next_stage", args.configuration)
    os.makedirs(out_dir, exist_ok=True)
    if args.folds:
        jobs = list(zip(args.folds, _fold_model_folders(args.model_folder, args.folds)))
    else:
        print("WARNING: no -f given: this one checkpoint predicts every case, its own training "
              "cases in fold, so the cascade's previous-stage channels will look unrealistically "
              "good in training. Pass -f 0 1 2 3 4 for nnU-Net's out-of-fold predictions.")
        jobs = [(None, args.model_folder)]

    # label mode: the argmax on the device; regions need the probabilities
    want_seg = not labels.has_regions
    for fold, folder in jobs:
        if fold is None:
            case_ids = src.case_ids
        else:
            trainer = get_trainer_class(args.trainer)(
                plans_path, args.configuration, int(fold), dataset_json,
                preprocessed_folder=args.dataset_folder, output_folder=folder, device=device)
            case_ids = trainer.get_split()[1].case_ids
        model = load_model(spec, os.path.join(folder, args.chk), device)
        predictor = build_predictor(
            model, mirror, tile_batch=args.tile_batch, output="seg" if want_seg else "probs",
            activation="sigmoid" if labels.has_regions else "softmax")
        for cid in case_ids:
            out = predictor(np.moveaxis(src.load(cid).data, 0, -1))
            seg = (out.astype(np.int16) if want_seg
                   else labels.convert_probabilities_to_segmentation(out))
            with np.load(os.path.join(dst_dir, f"{cid}.npz")) as z:
                target_shape = z["seg"].shape
            # the next configuration's seg kwargs; this stage's spacing to its
            seg_up = resample_data_or_seg_to_shape(
                seg, target_shape, cm.spacing, next_cm.spacing, is_seg=True,
                **next_cm.resampling_fn_seg_kwargs)
            np.savez_compressed(os.path.join(out_dir, f"{cid}.npz"), seg=seg_up.astype(np.int16))
            tag = "" if fold is None else f" (fold {fold})"
            print(f"{cid}{tag}: {seg.shape} -> {seg_up.shape}")
        del model, predictor
    print("done:", out_dir)
    return out_dir


if __name__ == "__main__":
    main()
