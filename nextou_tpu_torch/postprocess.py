"""Connected-component postprocessing (nnU-Net's determine_postprocessing).

Counterpart of ``nextou_tpu/postprocess.py``. nnU-Net's standard
postprocessing keeps, per foreground class, only
the largest connected component when cross-validation shows that this
improves Dice. CLI:

    python -m nextou_tpu_torch.postprocess determine GT_FOLDER PRED_FOLDER \
        [-o postprocessing.json]           # decide per class on CV preds
    python -m nextou_tpu_torch.postprocess apply PRED_FOLDER -o OUT_FOLDER \
        -pp postprocessing.json            # apply the decided operations
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
from scipy import ndimage

from nextou_tpu_torch.evaluate_folder import _load_seg, _seg_ids
from nextou_tpu_torch.infer.evaluate import dice_scores


def remove_all_but_largest_component(
    seg: np.ndarray, label: int
) -> np.ndarray:
    """Zero out every connected component of ``label`` except the largest."""
    mask = seg == label
    labeled, n = ndimage.label(mask)
    if n <= 1:
        return seg
    sizes = ndimage.sum_labels(
        np.ones_like(labeled), labeled, index=np.arange(1, n + 1)
    )
    keep = int(np.argmax(sizes)) + 1
    out = seg.copy()
    out[np.logical_and(mask, labeled != keep)] = 0
    return out


def determine_postprocessing(
    cases: list[tuple[np.ndarray, np.ndarray]], labels
) -> dict:
    """For each foreground label, keep-largest-component iff it does not
    hurt (and strictly helps somewhere) on the given (pred, gt) pairs —
    nnU-Net's CV-based decision."""
    decisions = {}
    for l in labels:
        if int(l) == 0:
            continue
        before, after = [], []
        for pred, gt in cases:
            b = dice_scores(pred, gt, [l])[int(l)]
            a = dice_scores(
                remove_all_but_largest_component(pred, int(l)), gt, [l]
            )[int(l)]
            if not (np.isnan(b) and np.isnan(a)):
                before.append(np.nan_to_num(b))
                after.append(np.nan_to_num(a))
        decisions[str(int(l))] = bool(
            before and np.mean(after) > np.mean(before)
        )
    return {"remove_all_but_largest_component": decisions}


def apply_postprocessing(seg: np.ndarray, pp: dict) -> np.ndarray:
    for l, do in pp.get("remove_all_but_largest_component", {}).items():
        if do:
            seg = remove_all_but_largest_component(seg, int(l))
    return seg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("determine")
    d.add_argument("gt_folder")
    d.add_argument("pred_folder")
    d.add_argument("-o", "--output", default=None)
    a = sub.add_parser("apply")
    a.add_argument("pred_folder")
    a.add_argument("-o", "--output", required=True)
    a.add_argument("-pp", "--postprocessing", required=True)
    args = ap.parse_args(argv)

    if args.cmd == "determine":
        ids = sorted(_seg_ids(args.gt_folder) & _seg_ids(args.pred_folder))
        if not ids:
            raise SystemExit("no common cases")
        cases, labels = [], set()
        for cid in ids:
            gt = _load_seg(args.gt_folder, cid).astype(np.int32)
            pred = _load_seg(args.pred_folder, cid).astype(np.int32)
            labels.update(np.unique(gt).tolist())
            cases.append((pred, gt))
        pp = determine_postprocessing(cases, sorted(labels))
        out = args.output or os.path.join(
            args.pred_folder, "postprocessing.json"
        )
        with open(out, "w") as f:
            json.dump(pp, f, indent=2)
        print(json.dumps(pp))
        print("written:", out)
    else:
        with open(args.postprocessing) as f:
            pp = json.load(f)
        os.makedirs(args.output, exist_ok=True)
        for cid in sorted(_seg_ids(args.pred_folder)):
            seg = apply_postprocessing(
                _load_seg(args.pred_folder, cid).astype(np.int16), pp
            )
            np.savez_compressed(
                os.path.join(args.output, f"{cid}.npz"), seg=seg
            )
            print("postprocessed", cid)


if __name__ == "__main__":
    main()
