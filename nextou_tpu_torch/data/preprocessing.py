"""Preprocessing: crop -> normalize -> resample (nnU-Net defaults).

Counterpart of ``nextou_tpu/data/preprocessing.py`` (numpy and scipy only):
crop to the nonzero bounding box, per-channel normalization by the plans'
schemes (Z-score, or CT with the dataset's foreground intensity
properties), cubic resampling of the data (order 3) and nearest for
segmentations (order 0) to the plans' target spacing; probabilities
resample back with order 1.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from nextou_tpu_torch import native
from nextou_tpu_torch.data.resampling import resample_data_or_seg_to_shape


def crop_to_nonzero(
    data: np.ndarray, seg: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray | None, list[tuple[int, int]]]:
    """Crop (C, *sp) data (and optional seg) to the union nonzero bbox."""
    mask = np.any(data != 0, axis=0)
    if not mask.any():
        bbox = [(0, s) for s in mask.shape]
    else:
        bbox = []
        for ax in range(mask.ndim):
            other = tuple(i for i in range(mask.ndim) if i != ax)
            nz = np.any(mask, axis=other)
            idx = np.where(nz)[0]
            bbox.append((int(idx[0]), int(idx[-1]) + 1))
    sl = tuple(slice(a, b) for a, b in bbox)
    data = data[(slice(None),) + sl]
    if seg is not None:
        seg = seg[sl]
    return data, seg, bbox


def zscore_normalize(
    data: np.ndarray, use_mask: bool = False, eps: float = 1e-8
) -> np.ndarray:
    """Per-channel Z-score over the whole (cropped) image, or over the
    nonzero mask when ``use_mask`` (nnU-Net's ZScoreNormalization)."""
    out = np.empty_like(data, dtype=np.float32)
    for c in range(data.shape[0]):
        x = data[c].astype(np.float32)
        if use_mask:
            m = x != 0
            mean, std = (x[m].mean(), x[m].std()) if m.any() else (0.0, 1.0)
            out[c] = np.where(m, (x - mean) / max(std, eps), 0.0)
        else:
            out[c] = (x - x.mean()) / max(x.std(), eps)
    return out


def ct_normalize(data: np.ndarray, props: dict) -> np.ndarray:
    """nnU-Net's CTNormalization: clip each channel to the dataset-wide
    foreground 0.5/99.5 percentiles, then scale by the foreground mean/std
    (statistics from the dataset fingerprint)."""
    out = np.empty_like(data, dtype=np.float32)
    for c in range(data.shape[0]):
        p = props[str(c)] if str(c) in props else props[c]
        x = np.clip(
            data[c].astype(np.float32),
            p["percentile_00_5"],
            p["percentile_99_5"],
        )
        out[c] = (x - p["mean"]) / max(p["std"], 1e-8)
    return out


def normalize(
    data: np.ndarray,
    schemes: list[str] | None = None,
    use_mask: list[bool] | None = None,
    intensity_props: dict | None = None,
) -> np.ndarray:
    """Apply the plans' per-channel normalization scheme."""
    if schemes is None:
        return zscore_normalize(data)
    out = np.empty_like(data, dtype=np.float32)
    for c in range(data.shape[0]):
        scheme = schemes[c] if c < len(schemes) else schemes[-1]
        ch = data[c : c + 1]
        if scheme == "CTNormalization":
            out[c] = ct_normalize(ch, {str(0): intensity_props[str(c)]})[0]
        elif scheme in ("NoNormalization", "noNorm"):
            out[c] = ch[0].astype(np.float32)
        else:  # ZScoreNormalization (default)
            m = bool(use_mask[c]) if use_mask and c < len(use_mask) else False
            out[c] = zscore_normalize(ch, use_mask=m)[0]
    return out


def resample_to_shape(
    x: np.ndarray, new_shape, order: int = 3, is_seg: bool = False
) -> np.ndarray:
    """Resample (*sp) array to ``new_shape``. Segs use order 0.

    Orders 0, 1 and 3 run on the port's g++-built resampler
    (:mod:`nextou_tpu_torch.native`, thread-parallel, ``scipy.ndimage.zoom``
    to within f32 rounding); other orders on ``scipy.ndimage.zoom``."""
    if tuple(x.shape) == tuple(new_shape):
        return x
    if is_seg:
        order = 0
    if order in (0, 1, 3):
        out = native.zoom_to_shape(x, new_shape, order)
        return out if not is_seg else out.astype(x.dtype)
    factors = [t / s for t, s in zip(new_shape, x.shape)]
    out = ndimage.zoom(x.astype(np.float32), factors, order=order)
    # fix off-by-one rounding
    if out.shape != tuple(new_shape):
        pad = [(0, max(0, t - o)) for t, o in zip(new_shape, out.shape)]
        out = np.pad(out, pad, mode="edge")[
            tuple(slice(0, t) for t in new_shape)
        ]
    return out.astype(np.float32) if not is_seg else out.astype(x.dtype)


def shape_for_spacing(shape, spacing, target_spacing) -> tuple[int, ...]:
    return tuple(
        int(round(s * sp / tsp))
        for s, sp, tsp in zip(shape, spacing, target_spacing)
    )


def preprocess_case(
    data: np.ndarray,
    seg: np.ndarray | None,
    spacing,
    target_spacing,
    use_mask_for_norm: bool | list[bool] = False,
    normalization_schemes: list[str] | None = None,
    intensity_props: dict | None = None,
    resampling_data_kwargs: dict | None = None,
    resampling_seg_kwargs: dict | None = None,
) -> tuple[np.ndarray, np.ndarray | None, dict]:
    """Full pipeline: crop -> normalize -> resample. Returns (data, seg, props).

    When the plans' resampling kwargs are given (``order``/``order_z``/
    ``force_separate_z``), resampling follows the substrate's
    ``resample_data_or_seg_to_shape`` exactly — half-pixel convention,
    anisotropy-dependent slice-wise separate-z, one-hot seg semantics
    (``data/resampling.py``). Without them the fast legacy path (native/scipy
    isotropic zoom, nearest segs) is kept for callers that predate the plans
    surface.
    """
    orig_shape = data.shape[1:]
    data, seg, bbox = crop_to_nonzero(data, seg)
    if normalization_schemes is not None:
        masks = (
            use_mask_for_norm
            if isinstance(use_mask_for_norm, (list, tuple))
            else [bool(use_mask_for_norm)] * data.shape[0]
        )
        data = normalize(data, normalization_schemes, list(masks), intensity_props)
    else:
        data = zscore_normalize(data, use_mask=bool(use_mask_for_norm))
    new_shape = shape_for_spacing(data.shape[1:], spacing, target_spacing)
    if resampling_data_kwargs is not None or resampling_seg_kwargs is not None:
        data = resample_data_or_seg_to_shape(
            data, new_shape, spacing, target_spacing, is_seg=False,
            **(resampling_data_kwargs or {}),
        )
        if seg is not None:
            seg = resample_data_or_seg_to_shape(
                seg, new_shape, spacing, target_spacing, is_seg=True,
                **(resampling_seg_kwargs or {}),
            )
    else:
        data = np.stack([resample_to_shape(c, new_shape, order=3) for c in data])
        if seg is not None:
            seg = resample_to_shape(seg, new_shape, is_seg=True)
    props = {
        "original_shape": list(orig_shape),
        "bbox": [list(b) for b in bbox],
        "spacing": list(spacing),
        "target_spacing": list(target_spacing),
        "shape_after_crop": list(data.shape[1:]),
    }
    return data, seg, props
