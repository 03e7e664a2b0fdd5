"""CLI: evaluate predicted segmentations against references.

Counterpart of ``nextou_tpu/evaluate_folder.py``, upstream's
``nnUNetv2_evaluate_folder``: compare two folders
of segmentations (``.npz`` with a ``seg`` array, or ``.nii/.nii.gz``) and
write an nnU-Net-style ``summary.json`` with per-class and foreground-mean
Dice / IoU / HD95 — the metrics the reference reports (BASELINE.md).

    python -m nextou_tpu_torch.evaluate_folder REF_FOLDER PRED_FOLDER \
        -djfile dataset.json [-o summary.json] [--spacing 1 1 1]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from nextou_tpu_torch.data.io import read_nifti
from nextou_tpu_torch.infer.evaluate import evaluate_cases
from nextou_tpu_torch.plans.loader import LabelManager

SEG_EXTS = (".npz", ".nii.gz", ".nii", ".npy")


def _seg_ids(folder: str) -> set[str]:
    """Case ids of every segmentation file (any supported extension)."""
    out = set()
    for f in os.listdir(folder):
        for e in SEG_EXTS:
            if f.endswith(e):
                out.add(f[: -len(e)])
                break
    return out


def _load_seg(folder: str, case_id: str) -> np.ndarray:
    for ext in SEG_EXTS:
        path = os.path.join(folder, case_id + ext)
        if os.path.exists(path):
            if ext == ".npz":
                with np.load(path) as z:
                    return z["seg"] if "seg" in z.files else z[z.files[0]]
            if ext == ".npy":
                return np.load(path)
            return read_nifti(path)[0]
    raise FileNotFoundError(f"no segmentation for '{case_id}' in {folder}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("ref_folder", help="ground-truth segmentations")
    ap.add_argument("pred_folder", help="predicted segmentations")
    ap.add_argument("-djfile", "--dataset-json", default=None,
                    help="dataset.json for the label list")
    ap.add_argument("-o", "--output", default=None,
                    help="summary.json path (default: pred_folder/summary.json)")
    ap.add_argument("--spacing", type=float, nargs="*", default=None,
                    help="voxel spacing for HD95 (default: unit voxels)")
    args = ap.parse_args(argv)

    case_ids = sorted(_seg_ids(args.ref_folder) & _seg_ids(args.pred_folder))
    if not case_ids:
        raise SystemExit(
            f"no common cases between {args.ref_folder} and {args.pred_folder}"
        )

    if args.dataset_json:
        with open(args.dataset_json) as f:
            dj = json.load(f)
        # region datasets are evaluated per region mask (nnU-Net
        # semantics); plain datasets per integer label
        lm = LabelManager(dj)
        labels = lm.foreground_regions if lm.has_regions else lm.all_labels
    else:
        labels = None

    cases = []
    seen = set()
    for cid in case_ids:
        ref = _load_seg(args.ref_folder, cid).astype(np.int32)
        pred = _load_seg(args.pred_folder, cid).astype(np.int32)
        if pred.shape != ref.shape:
            raise SystemExit(
                f"{cid}: shape mismatch pred {pred.shape} vs ref {ref.shape}"
            )
        seen.update(np.unique(ref).tolist())
        cases.append((pred, ref, cid))
    if labels is None:
        labels = sorted(int(l) for l in seen)

    out = args.output or os.path.join(args.pred_folder, "summary.json")
    summary = evaluate_cases(cases, labels, out, spacing=args.spacing)
    fg = summary["foreground_mean"]
    print(
        f"{len(cases)} cases, labels {labels}: "
        f"mean Dice {fg['Dice']:.4f}  IoU {fg['IoU']:.4f}  "
        f"HD95 {fg['HD95']:.3f}"
    )
    print("written:", out)


if __name__ == "__main__":
    main()
