"""Preprocessed dataset storage and fold splits.

Carried over unchanged from ``nextou_tpu/data/dataset.py`` (numpy and json
only): the port imports nothing of the JAX package, so it keeps its own copy.

Cases are stored one ``.npz`` per case: ``data`` float32 (C, *spatial),
``seg`` int16 (*spatial) — the moral equivalent of nnU-Net's preprocessed
``.npz``/``.npy`` pairs. Foreground voxel coordinates per class are cached at
save time so the patch sampler's oversampling does not rescan volumes
(nnU-Net stores the same thing in its preprocessing pickle).
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass

import numpy as np


def save_case(
    folder: str,
    case_id: str,
    data: np.ndarray,
    seg: np.ndarray,
    max_fg_locations: int = 10000,
    properties: dict | None = None,
):
    """Write one preprocessed case with cached class locations."""
    os.makedirs(folder, exist_ok=True)
    assert data.ndim == seg.ndim + 1, (data.shape, seg.shape)
    # stable per-case seed: str.__hash__ is randomized per process
    # (PYTHONHASHSEED), which would make fg-location subsampling — and thus
    # every downstream oversampled patch — non-reproducible across runs
    rng = np.random.default_rng(zlib.crc32(case_id.encode()))
    class_locs = {}
    for c in np.unique(seg):
        if c <= 0:
            continue
        locs = np.argwhere(seg == c)
        if len(locs) > max_fg_locations:
            locs = locs[rng.choice(len(locs), max_fg_locations, replace=False)]
        class_locs[int(c)] = locs.astype(np.int32)
    np.savez_compressed(
        os.path.join(folder, f"{case_id}.npz"),
        data=data.astype(np.float32),
        seg=seg.astype(np.int16),
        **{f"fg_{c}": v for c, v in class_locs.items()},
    )
    if properties:
        with open(os.path.join(folder, f"{case_id}.json"), "w") as f:
            json.dump(properties, f)


@dataclass
class Case:
    data: np.ndarray  # (C, *sp) float32
    seg: np.ndarray  # (*sp) int16
    class_locations: dict[int, np.ndarray]
    properties: dict
    seg_prev: np.ndarray | None = None  # cascade: previous-stage prediction


class PreprocessedDataset:
    """A folder of preprocessed ``.npz`` cases.

    ``prev_stage_folder`` (cascade configurations) points at a folder of
    ``{case_id}.npz`` files holding the previous stage's predicted ``seg``
    resampled to this configuration's grid (written by
    ``python -m nextou_tpu.predict_next_stage``)."""

    def __init__(
        self,
        folder: str,
        case_ids: list[str] | None = None,
        prev_stage_folder: str | None = None,
    ):
        self.folder = folder
        self.prev_stage_folder = prev_stage_folder
        if case_ids is None:
            case_ids = sorted(
                f[:-4] for f in os.listdir(folder) if f.endswith(".npz")
            )
        self.case_ids = case_ids

    def __len__(self):
        return len(self.case_ids)

    def load(self, case_id: str) -> Case:
        with np.load(os.path.join(self.folder, f"{case_id}.npz")) as z:
            data = z["data"]
            seg = z["seg"]
            class_locs = {
                int(k[3:]): z[k] for k in z.files if k.startswith("fg_")
            }
        props_path = os.path.join(self.folder, f"{case_id}.json")
        props = {}
        if os.path.exists(props_path):
            with open(props_path) as f:
                props = json.load(f)
        seg_prev = None
        if self.prev_stage_folder is not None:
            prev_path = os.path.join(self.prev_stage_folder, f"{case_id}.npz")
            with np.load(prev_path) as z:
                seg_prev = z["seg"]
            assert seg_prev.shape == seg.shape, (
                f"{case_id}: previous-stage seg {seg_prev.shape} does not "
                f"match this configuration's grid {seg.shape}"
            )
        return Case(
            data=data, seg=seg, class_locations=class_locs,
            properties=props, seg_prev=seg_prev,
        )

    def subset(self, case_ids: list[str]) -> "PreprocessedDataset":
        return PreprocessedDataset(
            self.folder, case_ids, prev_stage_folder=self.prev_stage_folder
        )


def make_splits(case_ids: list[str], n_folds: int = 5, seed: int = 12345):
    """nnU-Net-style 5-fold CV splits (shuffled K-fold)."""
    rng = np.random.default_rng(seed)
    ids = np.array(sorted(case_ids))
    perm = rng.permutation(len(ids))
    folds = []
    for k in range(n_folds):
        val_idx = perm[k::n_folds]
        val = set(ids[val_idx].tolist())
        folds.append(
            {
                "train": [i for i in ids.tolist() if i not in val],
                "val": sorted(val),
            }
        )
    return folds
