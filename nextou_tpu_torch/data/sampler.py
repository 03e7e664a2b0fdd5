"""Patch sampling with foreground oversampling.

Counterpart of ``nextou_tpu/data/sampler.py``, carried over as it is (numpy
only), so that a seed draws the JAX package's patches. nnU-Net semantics:
each batch draws random cases; a fixed trailing fraction of the batch
(33.3%) is forced to contain foreground by centering the patch on a random
cached foreground voxel of a random present class; patches at volume
borders are zero-padded (data) / padded with label 0 (seg).
"""

from __future__ import annotations

import threading

import numpy as np

from nextou_tpu_torch.data.dataset import Case, PreprocessedDataset


def extract_patch(
    data: np.ndarray, seg: np.ndarray, center: np.ndarray, patch_size
) -> tuple[np.ndarray, np.ndarray]:
    """Extract (C, *patch) / (*patch) around ``center``, zero-padded."""
    sp = np.array(seg.shape)
    ps = np.array(patch_size)
    lo = center - ps // 2
    hi = lo + ps
    src_lo = np.maximum(lo, 0)
    src_hi = np.minimum(hi, sp)
    dst_lo = src_lo - lo
    dst_hi = dst_lo + (src_hi - src_lo)

    out_d = np.zeros((data.shape[0], *patch_size), np.float32)
    out_s = np.zeros(tuple(patch_size), np.int16)
    src = tuple(slice(a, b) for a, b in zip(src_lo, src_hi))
    dst = tuple(slice(a, b) for a, b in zip(dst_lo, dst_hi))
    out_d[(slice(None),) + dst] = data[(slice(None),) + src]
    out_s[dst] = seg[src]
    return out_d, out_s


class PatchSampler:
    """Draws (data, seg) patch batches from a preprocessed dataset."""

    def __init__(
        self,
        dataset: PreprocessedDataset,
        patch_size,
        batch_size: int,
        oversample_foreground_percent: float = 0.333,
        seed: int = 0,
        cache_cases: bool = True,
    ):
        self.dataset = dataset
        self.patch_size = tuple(patch_size)
        self.batch_size = batch_size
        self.oversample = oversample_foreground_percent
        self.rng = np.random.default_rng(seed)
        self._cache: dict[str, Case] = {}
        self._cache_lock = threading.Lock()
        self.cache_cases = cache_cases

    def _get(self, case_id: str) -> Case:
        if self.cache_cases:
            # thread-safe: loader threads share the sampler; only the cache
            # insert needs the lock, loads run concurrently
            case = self._cache.get(case_id)
            if case is None:
                case = self.dataset.load(case_id)
                with self._cache_lock:
                    case = self._cache.setdefault(case_id, case)
            return case
        return self.dataset.load(case_id)

    def _sample_center(self, case: Case, force_fg: bool) -> np.ndarray:
        return self._sample_center_for(case, force_fg, self.patch_size, self.rng)

    def _sample_center_for(
        self, case: Case, force_fg: bool, patch_size,
        rng: np.random.Generator | None = None,
    ) -> np.ndarray:
        rng = self.rng if rng is None else rng
        sp = np.array(case.seg.shape)
        if force_fg and case.class_locations:
            cls = rng.choice(list(case.class_locations.keys()))
            locs = case.class_locations[cls]
            return locs[rng.integers(len(locs))].astype(np.int64)
        ps = np.array(patch_size)
        lo = np.minimum(ps // 2, sp // 2)
        # hi is the INCLUSIVE last valid center (start sp-ps); rng.integers'
        # exclusive upper bound therefore gets +1, otherwise the volume's
        # trailing plane per axis is never sampled uniformly
        hi = np.maximum(sp - ps + ps // 2, lo)
        return np.array(
            [rng.integers(l, h + 1) for l, h in zip(lo, hi)], np.int64
        )

    def sample_batch(
        self,
        rng: np.random.Generator | None = None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
        """Returns data (B, C, *patch) float32, seg (B, *patch) int16, and —
        for cascade datasets — the previous-stage seg patch (B, *patch)
        int16 (None otherwise).

        A 2D ``patch_size`` over a 3D dataset samples one random slice per
        patch (nnU-Net's 2d-configuration training on volumetric data): the
        center voxel — foreground-oversampled or uniform — picks the slice.
        """
        rng = self.rng if rng is None else rng
        n_fg = round(self.batch_size * self.oversample)
        datas, segs, prevs = [], [], []
        for i in range(self.batch_size):
            case_id = self.dataset.case_ids[
                rng.integers(len(self.dataset.case_ids))
            ]
            case = self._get(case_id)
            force_fg = i >= self.batch_size - n_fg
            patch = self.patch_size
            slice_from_3d = len(patch) == case.seg.ndim - 1
            if slice_from_3d:
                patch = (1, *patch)
            center = self._sample_center_for(case, force_fg, patch, rng)
            d, s = extract_patch(case.data, case.seg, center, patch)
            if case.seg_prev is not None:
                _, p = extract_patch(
                    case.seg_prev[None], case.seg_prev, center, patch
                )
                prevs.append(p[0] if slice_from_3d else p)
            if slice_from_3d:
                d, s = d[:, 0], s[0]
            datas.append(d)
            segs.append(s)
        prev = np.stack(prevs) if prevs else None
        return np.stack(datas), np.stack(segs), prev
