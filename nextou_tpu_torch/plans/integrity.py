"""Raw-dataset integrity verification.

Counterpart of ``nextou_tpu/plans/integrity.py``, nnU-Net's
``nnUNetv2_plan_and_preprocess --verify_dataset_integrity``: checks, before
any preprocessing, that

- ``dataset.json`` exists with ``labels`` (0 = background) and
  ``channel_names``/``modality``;
- every training case has all channel images and a label file, and
  ``numTraining`` matches the number of cases found;
- per case, every channel image and the segmentation share shape and
  spacing (within tolerance);
- the segmentation contains only labels declared in ``dataset.json``
  (region-style list labels and ``ignore_label`` included);
- no image contains NaN/inf.

Returns a list of human-readable problem strings (empty = OK), the same
strings in the same order as the JAX package's.
"""

from __future__ import annotations

import json
import os

import numpy as np

from nextou_tpu_torch.data.io import read_image


def _expected_labels(dataset_json: dict) -> set[int]:
    out: set[int] = set()
    for v in dataset_json.get("labels", {}).values():
        if isinstance(v, (list, tuple)):
            out.update(int(x) for x in v)
        else:
            out.add(int(v))
    ignore = dataset_json.get("ignore_label")
    if ignore is not None:
        out.add(int(ignore))
    return out


def verify_dataset_integrity(
    raw_folder: str, max_cases: int | None = None
) -> list[str]:
    problems: list[str] = []
    dj_path = os.path.join(raw_folder, "dataset.json")
    if not os.path.isfile(dj_path):
        return [f"missing {dj_path}"]
    with open(dj_path) as f:
        dj = json.load(f)

    labels = dj.get("labels")
    if not labels:
        problems.append("dataset.json has no 'labels'")
        labels = {}
    bg = labels.get("background")
    if bg not in (0, [0]):
        problems.append(
            "dataset.json labels must map 'background' to 0 "
            f"(got {bg!r})"
        )
    channels = dj.get("channel_names", dj.get("modality"))
    if not channels:
        problems.append("dataset.json has neither channel_names nor modality")
        channels = {"0": "?"}
    n_channels = len(channels)
    ending = dj.get("file_ending", ".nii.gz")

    labels_dir = os.path.join(raw_folder, "labelsTr")
    images_dir = os.path.join(raw_folder, "imagesTr")
    if not os.path.isdir(labels_dir) or not os.path.isdir(images_dir):
        problems.append("missing imagesTr/ or labelsTr/")
        return problems
    case_ids = sorted(
        f[: -len(ending)] for f in os.listdir(labels_dir) if f.endswith(ending)
    )
    n_training = dj.get("numTraining")
    if n_training is not None and int(n_training) != len(case_ids):
        problems.append(
            f"numTraining={n_training} but {len(case_ids)} label files found"
        )

    expected = _expected_labels(dj)
    for cid in case_ids[: max_cases if max_cases else len(case_ids)]:
        seg, _seg_spacing = read_image(os.path.join(labels_dir, cid + ending))
        seg = seg[0] if seg.ndim == 4 else seg
        found = set(np.unique(seg).astype(int).tolist())
        extra = found - expected
        if extra:
            problems.append(f"{cid}: labels {sorted(extra)} not in dataset.json")
        ref_shape, ref_spacing = None, None
        for c in range(n_channels):
            img_path = os.path.join(images_dir, f"{cid}_{c:04d}{ending}")
            if not os.path.isfile(img_path):
                problems.append(f"{cid}: missing channel image {img_path}")
                continue
            img, spacing = read_image(img_path)
            img = img[0] if img.ndim == 4 else img
            if not np.isfinite(img).all():
                problems.append(f"{cid}_{c:04d}: contains NaN/inf")
            if ref_shape is None:
                ref_shape, ref_spacing = img.shape, spacing or None
            elif img.shape != ref_shape:
                problems.append(
                    f"{cid}: channel {c} shape {img.shape} != {ref_shape}"
                )
            sp = spacing or None
            if (
                ref_spacing is not None
                and sp is not None
                and not np.allclose(sp, ref_spacing, rtol=1e-3)
            ):
                problems.append(
                    f"{cid}: channel {c} spacing {sp} != {ref_spacing}"
                )
        if ref_shape is not None and tuple(seg.shape) != tuple(ref_shape):
            problems.append(
                f"{cid}: seg shape {tuple(seg.shape)} != image {ref_shape}"
            )
        seg_sp = _seg_spacing or None
        if (
            ref_spacing is not None
            and seg_sp is not None
            and len(seg_sp) == len(ref_spacing)
            and not np.allclose(seg_sp, ref_spacing, rtol=1e-3)
        ):
            problems.append(
                f"{cid}: seg spacing {seg_sp} != image {ref_spacing}"
            )
    return problems
