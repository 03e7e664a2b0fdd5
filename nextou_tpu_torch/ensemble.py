"""Ensemble predictions from multiple models/configurations.

Counterpart of ``nextou_tpu/ensemble.py``, upstream's ``nnUNetv2_ensemble``:
average the saved
probabilities (``predict --save-probabilities``) from two or more prediction
folders and convert to a segmentation — argmax for plain-label datasets,
threshold + regions_class_order painting for region-based ones. The label
semantics come from dataset.json, auto-discovered in the prediction folders
(predict writes it there) or passed via ``-djfile``.

    python -m nextou_tpu_torch.ensemble FOLDER1 FOLDER2 [...] -o OUT_FOLDER
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from nextou_tpu_torch.plans.loader import LabelManager


def ensemble_case(prob_list: list[np.ndarray], label_manager=None) -> np.ndarray:
    mean = np.mean([p.astype(np.float32) for p in prob_list], axis=0)
    if label_manager is not None:
        return label_manager.convert_probabilities_to_segmentation(mean)
    return np.argmax(mean, axis=-1).astype(np.int16)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("folders", nargs="+", help=">= 2 prediction folders")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument(
        "-djfile", "--dataset-json", default=None,
        help="dataset.json — REQUIRED for region-based datasets so the "
             "averaged sigmoid probabilities convert back to labels "
             "correctly (otherwise argmax)",
    )
    args = ap.parse_args(argv)
    if len(args.folders) < 2:
        raise SystemExit("need at least two prediction folders to ensemble")

    def ids(folder):
        return {f[:-4] for f in os.listdir(folder) if f.endswith(".npz")}

    common = sorted(set.intersection(*[ids(f) for f in args.folders]))
    if not common:
        raise SystemExit("no common cases across the folders")
    dj_path = args.dataset_json
    if dj_path is None:  # predict drops dataset.json next to its outputs
        for folder in args.folders:
            cand = os.path.join(folder, "dataset.json")
            if os.path.exists(cand):
                dj_path = cand
                break
    lm = None
    if dj_path is not None:
        with open(dj_path) as f:
            lm = LabelManager(json.load(f))
    else:
        print(
            "WARNING: no dataset.json found in the prediction folders and "
            "-djfile not given — assuming plain labels (argmax). For "
            "region-based datasets this produces WRONG segmentations."
        )
    os.makedirs(args.output, exist_ok=True)
    for cid in common:
        probs = []
        for folder in args.folders:
            with np.load(os.path.join(folder, f"{cid}.npz")) as z:
                if "probabilities" not in z.files:
                    raise SystemExit(
                        f"{folder}/{cid}.npz has no probabilities — predict "
                        "with --save-probabilities"
                    )
                probs.append(z["probabilities"])
        seg = ensemble_case(probs, lm)
        np.savez_compressed(os.path.join(args.output, f"{cid}.npz"), seg=seg)
        print(f"ensembled {cid}: {seg.shape}")


if __name__ == "__main__":
    main()
