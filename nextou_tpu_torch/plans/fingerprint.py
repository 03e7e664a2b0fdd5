"""Dataset fingerprint extraction.

Counterpart of ``nextou_tpu/plans/fingerprint.py`` (numpy only), nnU-Net
v2's DatasetFingerprintExtractor, the first stage of
``nnUNetv2_plan_and_preprocess``: scan a raw dataset folder
(``imagesTr``/``labelsTr`` + ``dataset.json``), record each case's spacing
and shape after cropping, and sample foreground intensities per channel for
the normalization statistics (CTNormalization clips to the 0.5/99.5
foreground percentiles). The same folder and seed give the same fingerprint
as the JAX package's.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

from nextou_tpu_torch.data.io import read_image
from nextou_tpu_torch.data.preprocessing import crop_to_nonzero

NUM_FOREGROUND_SAMPLES_PER_CASE = 10_000


def _case_ids(raw_folder: str, dataset_json: dict[str, Any]) -> list[str]:
    ending = dataset_json.get("file_ending", ".nii.gz")
    labels_dir = os.path.join(raw_folder, "labelsTr")
    ids = sorted(
        f[: -len(ending)]
        for f in os.listdir(labels_dir)
        if f.endswith(ending)
    )
    return ids


def _image_paths(
    raw_folder: str, case_id: str, n_channels: int, ending: str
) -> list[str]:
    return [
        os.path.join(raw_folder, "imagesTr", f"{case_id}_{c:04d}{ending}")
        for c in range(n_channels)
    ]


def extract_case_fingerprint(
    images: np.ndarray,
    seg: np.ndarray,
    spacing,
    rng: np.random.Generator,
    num_samples: int = NUM_FOREGROUND_SAMPLES_PER_CASE,
) -> dict[str, Any]:
    """Fingerprint one case from in-memory arrays (images: (C, *sp))."""
    shape_before = images.shape[1:]
    cropped, seg_c, _ = crop_to_nonzero(images, seg)
    fg = seg_c > 0 if seg_c is not None else np.ones(cropped.shape[1:], bool)
    samples = []
    for c in range(cropped.shape[0]):
        vals = cropped[c][fg].astype(np.float32)
        if vals.size > num_samples:
            vals = rng.choice(vals, num_samples, replace=False)
        samples.append(vals)
    return {
        "spacing": [float(s) for s in spacing],
        "shape_before_crop": [int(s) for s in shape_before],
        "shape_after_crop": [int(s) for s in cropped.shape[1:]],
        "foreground_samples": samples,
    }


def extract_fingerprint(
    raw_folder: str,
    dataset_json: dict[str, Any] | None = None,
    max_cases: int | None = None,
    seed: int = 1234,
) -> dict[str, Any]:
    """Scan ``raw_folder`` and return the dataset fingerprint dict consumed
    by :func:`nextou_tpu_torch.plans.planner.plan_experiment`."""
    if dataset_json is None:
        with open(os.path.join(raw_folder, "dataset.json")) as f:
            dataset_json = json.load(f)
    ending = dataset_json.get("file_ending", ".nii.gz")
    channel_names = dataset_json.get(
        "channel_names", dataset_json.get("modality", {"0": "noNorm"})
    )
    n_channels = len(channel_names)
    rng = np.random.default_rng(seed)

    ids = _case_ids(raw_folder, dataset_json)
    if max_cases is not None:
        ids = ids[:max_cases]

    spacings, shapes_after, rel_sizes = [], [], []
    channel_samples: list[list[np.ndarray]] = [[] for _ in range(n_channels)]
    for cid in ids:
        seg, _ = read_image(
            os.path.join(raw_folder, "labelsTr", f"{cid}{ending}")
        )
        # a volume stored 4D with a singleton leading axis passes
        # verify_dataset_integrity (the same squeeze there) and must not grow
        # a phantom spatial axis in the fingerprint
        seg = seg[0] if seg.ndim == 4 else seg
        chans, spacing = [], None
        for p in _image_paths(raw_folder, cid, n_channels, ending):
            arr, sp = read_image(p)
            chans.append(arr[0] if arr.ndim == 4 else arr)
            spacing = sp or spacing
        images = np.stack(chans)
        if not spacing:
            spacing = (1.0,) * seg.ndim
        fp = extract_case_fingerprint(images, seg.astype(np.int64), spacing, rng)
        spacings.append(fp["spacing"])
        shapes_after.append(fp["shape_after_crop"])
        rel_sizes.append(
            float(np.prod(fp["shape_after_crop"]))
            / float(np.prod(fp["shape_before_crop"]))
        )
        for c in range(n_channels):
            channel_samples[c].append(fp["foreground_samples"][c])

    intensity_props = {}
    for c in range(n_channels):
        vals = (
            np.concatenate(channel_samples[c])
            if channel_samples[c]
            else np.zeros(1, np.float32)
        )
        if vals.size == 0:
            vals = np.zeros(1, np.float32)
        intensity_props[str(c)] = {
            "max": float(vals.max()),
            "mean": float(vals.mean()),
            "median": float(np.median(vals)),
            "min": float(vals.min()),
            "percentile_00_5": float(np.percentile(vals, 0.5)),
            "percentile_99_5": float(np.percentile(vals, 99.5)),
            "std": float(vals.std()),
        }

    return {
        "spacings": spacings,
        "shapes_after_crop": shapes_after,
        "median_relative_size_after_cropping": float(np.median(rel_sizes)),
        "foreground_intensity_properties_per_channel": intensity_props,
        "case_ids": ids,
    }
