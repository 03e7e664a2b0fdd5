"""Evaluation: per-class Dice / IoU / HD95 and nnU-Net's ``summary.json``.

Counterpart of ``nextou_tpu/infer/evaluate.py``, carried over as it is
(numpy and scipy only). The trainer's final validation writes
``validation/summary.json`` with per-class metrics, the substrate's output,
so that quality is comparable with the reference's tables (mean DSC and mean
HD95).
"""

from __future__ import annotations

import json
import os

import numpy as np
from scipy import ndimage


def dice_scores(pred: np.ndarray, ref: np.ndarray, labels) -> dict[int, float]:
    """Hard Dice per label; NaN when the label is absent from both."""
    out = {}
    for l in labels:
        p = pred == l
        g = ref == l
        denom = p.sum() + g.sum()
        if denom == 0:
            out[int(l)] = float("nan")
        else:
            out[int(l)] = float(2.0 * np.logical_and(p, g).sum() / denom)
    return out


def _surface(mask: np.ndarray) -> np.ndarray:
    return mask ^ ndimage.binary_erosion(mask)


def hd95(
    pred: np.ndarray, ref: np.ndarray, spacing=None
) -> float:
    """95th-percentile symmetric Hausdorff distance between binary masks
    (the reference's second headline metric, BASELINE.md). NaN when either
    mask is empty (no surface to measure)."""
    if not pred.any() or not ref.any():
        return float("nan")
    pb, gb = _surface(pred), _surface(ref)
    if not pb.any() or not gb.any():
        return float("nan")
    dg = ndimage.distance_transform_edt(~gb, sampling=spacing)
    dp = ndimage.distance_transform_edt(~pb, sampling=spacing)
    dists = np.concatenate([dg[pb], dp[gb]])
    return float(np.percentile(dists, 95))


def _label_mask(arr: np.ndarray, l) -> np.ndarray:
    """Membership mask for an int label or a region (tuple of labels)."""
    if isinstance(l, (tuple, list)):
        return np.isin(arr, list(l))
    return arr == l


def label_key(l) -> str:
    """summary.json key: '2' for plain labels, '(1, 2, 3)' for regions
    (nnU-Net's region keys)."""
    if isinstance(l, (tuple, list)):
        if len(l) == 1:
            return str(int(l[0]))
        return str(tuple(int(x) for x in l))
    return str(int(l))


def case_metrics(
    pred: np.ndarray, ref: np.ndarray, labels, spacing=None
) -> dict[str, dict[str, float]]:
    """Per-label Dice / IoU / HD95 / TP-FP-FN counts for one case.

    ``labels`` entries may be ints or regions (tuples of ints, evaluated as
    membership masks — nnU-Net's region-based evaluation)."""
    out = {}
    for l in labels:
        p = _label_mask(pred, l)
        g = _label_mask(ref, l)
        tp = int(np.logical_and(p, g).sum())
        fp = int(p.sum()) - tp
        fn = int(g.sum()) - tp
        denom = 2 * tp + fp + fn
        dice = float("nan") if denom == 0 else 2.0 * tp / denom
        union = tp + fp + fn
        iou = float("nan") if union == 0 else tp / union
        is_bg = not isinstance(l, (tuple, list)) and int(l) == 0
        out[label_key(l)] = {
            "Dice": dice,
            "IoU": iou,
            "HD95": float("nan") if is_bg else hd95(p, g, spacing),
            "TP": tp,
            "FP": fp,
            "FN": fn,
        }
    return out


def evaluate_cases(
    cases: list[tuple[np.ndarray, np.ndarray, str]],
    labels,
    output_file: str | None = None,
    spacing=None,
) -> dict:
    """cases: list of (pred_seg, ref_seg, case_id)."""
    metric_per_case = []
    for pred, ref, cid in cases:
        metric_per_case.append(
            {"case": cid, "metrics": case_metrics(pred, ref, labels, spacing)}
        )
    return summarize_metrics(metric_per_case, labels, output_file)


def summarize_metrics(
    metric_per_case: list[dict],
    labels,
    output_file: str | None = None,
) -> dict:
    """Aggregate per-case ``case_metrics`` entries ({'case', 'metrics'})
    into the summary.json structure (per-label and foreground means)."""

    def _mean(label: str, metric: str) -> float:
        vals = [
            c["metrics"][label][metric]
            for c in metric_per_case
            if not np.isnan(c["metrics"][label][metric])
        ]
        return float(np.mean(vals)) if vals else float("nan")

    mean = {
        label_key(l): {
            m: _mean(label_key(l), m) for m in ("Dice", "IoU", "HD95")
        }
        for l in labels
    }
    fg_labels = [label_key(l) for l in labels if label_key(l) != "0"]
    fg_mean = {}
    for m in ("Dice", "IoU", "HD95"):
        vals = [mean[l][m] for l in fg_labels if not np.isnan(mean[l][m])]
        fg_mean[m] = float(np.mean(vals)) if vals else float("nan")
    summary = {
        "metric_per_case": metric_per_case,
        "mean": mean,
        "foreground_mean": fg_mean,
    }
    if output_file:
        os.makedirs(os.path.dirname(os.path.abspath(output_file)), exist_ok=True)
        with open(output_file, "w") as f:
            json.dump(summary, f, indent=2, default=float)
    return summary
