"""nnU-Net-faithful resampling: ``resample_data_or_seg_to_shape`` semantics.

Counterpart of ``nextou_tpu/data/resampling.py``, carried over with the
same results (the separate-z path takes each slice as a view).
The plans upstream ships hard-code this resampler and its kwargs (data
order 3, seg order 0, probabilities order 1, all with ``order_z: 0,
force_separate_z: null``).
This module reproduces the substrate function's exact behavior so the
preprocessing/inference pipeline dispatches on those kwargs end-to-end:

- **Coordinate convention**: skimage ``resize(..., anti_aliasing=False,
  mode='edge')``, i.e. half-pixel centers — output voxel ``i`` samples input
  coordinate ``(i + 0.5) * (n_in / n_out) - 0.5`` with edge clamping. That is
  exactly ``scipy.ndimage.zoom(..., grid_mode=True, mode='nearest')``, which
  is what we call. (NOT the endpoint-aligned ``zoom(grid_mode=False)``
  convention used by the fast legacy path in ``preprocessing.py``.)
- **Anisotropy dispatch**: when ``force_separate_z`` is None, resampling goes
  slice-wise when max(spacing)/min(spacing) > 3 for either the current or the
  target spacing (``ANISO_THRESHOLD``); the low-resolution axis is where
  spacing is maximal. Each in-plane slice is resized with ``order``; the
  low-res axis is then interpolated with ``order_z`` (0 = nearest — the
  plans' default, which avoids smearing across thick CT slices).
- **Segmentation semantics**: ``resize_segmentation`` — order 0 is a plain
  nearest resize; order > 0 resizes a one-hot (float) mask per label and
  assigns labels where the resized mask crosses 0.5, in ascending label
  order (ties go to the larger label). The separate-z path uses the same
  one-hot treatment along z when ``order_z > 0``.

Everything is host-side NumPy/SciPy (preprocessing is offline); shapes are
(C, *spatial) for data and (*spatial) or (C, *spatial) for segs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
from scipy import ndimage

ANISO_THRESHOLD = 3.0


def get_do_separate_z(
    spacing: Sequence[float], anisotropy_threshold: float = ANISO_THRESHOLD
) -> bool:
    """True when the spacing is anisotropic beyond the threshold."""
    spacing = np.asarray(spacing, dtype=float)
    return bool(spacing.max() / spacing.min() > anisotropy_threshold)


def get_lowres_axis(spacing: Sequence[float]) -> np.ndarray:
    """Axes whose spacing equals the maximum (the thick-slice axes)."""
    spacing = np.asarray(spacing, dtype=float)
    return np.where(spacing.max() / spacing == 1.0)[0]


def resize_half_pixel(
    x: np.ndarray, new_shape: Sequence[int], order: int, clip: bool = True
) -> np.ndarray:
    """skimage ``resize(anti_aliasing=False, mode='edge')`` equivalent.

    Half-pixel-centered spline resize with edge clamping, output clipped to
    the input's value range (skimage's ``clip=True`` default).
    """
    new_shape = tuple(int(t) for t in new_shape)
    x = np.asarray(x, dtype=np.float64)
    if x.shape == new_shape:
        return x.copy()
    factors = [t / s for t, s in zip(new_shape, x.shape)]
    out = ndimage.zoom(x, factors, order=order, mode="nearest", grid_mode=True)
    if out.shape != new_shape:  # guard against float rounding of the factor
        pad = [(0, max(0, t - o)) for t, o in zip(new_shape, out.shape)]
        out = np.pad(out, pad, mode="edge")[
            tuple(slice(0, t) for t in new_shape)
        ]
    if clip and x.size:
        out = np.clip(out, x.min(), x.max())
    return out


def resize_segmentation(
    seg: np.ndarray, new_shape: Sequence[int], order: int
) -> np.ndarray:
    """Label-map resize: nearest for order 0, per-label one-hot otherwise.

    order > 0: each label's binary mask is resized as float with ``order``
    and voxels where the resized mask >= 0.5 take that label, iterating
    labels in ascending order (later labels overwrite on ties) — the
    substrate's ``resize_segmentation``.
    """
    new_shape = tuple(int(t) for t in new_shape)
    if seg.shape == new_shape:
        return seg.copy()
    if order == 0:
        return resize_half_pixel(seg.astype(np.float64), new_shape, 0).astype(
            seg.dtype
        )
    out = np.zeros(new_shape, dtype=seg.dtype)
    for lab in np.sort(np.unique(seg)):
        mask = resize_half_pixel((seg == lab).astype(np.float64), new_shape, order)
        out[mask >= 0.5] = lab
    return out


def _resize_along_axis(
    x: np.ndarray, axis: int, n_out: int, order: int
) -> np.ndarray:
    """Half-pixel resize along one axis only (identity on the others)."""
    factors = [1.0] * x.ndim
    factors[axis] = n_out / x.shape[axis]
    out = ndimage.zoom(
        np.asarray(x, dtype=np.float64),
        factors,
        order=order,
        mode="nearest",
        grid_mode=True,
    )
    if out.shape[axis] != n_out:
        sl = [slice(None)] * x.ndim
        if out.shape[axis] > n_out:
            sl[axis] = slice(0, n_out)
            out = out[tuple(sl)]
        else:
            pad = [(0, 0)] * x.ndim
            pad[axis] = (0, n_out - out.shape[axis])
            out = np.pad(out, pad, mode="edge")
    return out


def resample_data_or_seg(
    data: np.ndarray,
    new_shape: Sequence[int],
    is_seg: bool,
    axis: Sequence[int] | None = None,
    order: int = 3,
    do_separate_z: bool = False,
    order_z: int = 0,
) -> np.ndarray:
    """Core resampler on (C, *spatial) arrays (substrate semantics).

    ``do_separate_z``: resize every slice perpendicular to ``axis[0]``
    in-plane with ``order``, then interpolate along that axis with
    ``order_z`` (segs with ``order_z > 0`` go one-hot-per-label, rounded,
    thresholded at 0.5).
    """
    assert data.ndim - 1 == len(new_shape), (
        f"data (C, *spatial) {data.shape} vs new_shape {new_shape}"
    )
    new_shape = tuple(int(t) for t in new_shape)
    out_dtype = data.dtype if is_seg else np.float32
    if data.shape[1:] == new_shape:
        return data.astype(out_dtype, copy=True)

    def resize_fn(arr, shape, o):
        return (
            resize_segmentation(arr, shape, o)
            if is_seg
            else resize_half_pixel(arr, shape, o)
        )

    channels = []
    if do_separate_z and data.ndim == 4:
        z = int(np.asarray(axis).ravel()[0])
        plane_axes = [a for a in range(3) if a != z]
        new_shape_2d = tuple(new_shape[a] for a in plane_axes)
        for c in range(data.shape[0]):
            vol = data[c]
            # a view of each slice: ``np.take`` (the reference's call) first
            # copies a non-contiguous ``vol`` whole, once per slice, which
            # made the probabilities' resampling back (channels last, moved
            # first) 5x slower; the values are the same
            slices = [
                resize_fn(vol[(slice(None),) * z + (s,)], new_shape_2d, order)
                for s in range(vol.shape[z])
            ]
            stacked = np.stack(slices, axis=z)
            if stacked.shape[z] != new_shape[z]:
                if not is_seg or order_z == 0:
                    stacked = _resize_along_axis(
                        stacked, z, new_shape[z], order_z
                    )
                else:
                    merged = np.zeros(new_shape, dtype=data.dtype)
                    for lab in np.sort(np.unique(stacked)):
                        onehot = np.round(
                            _resize_along_axis(
                                (stacked == lab).astype(np.float64),
                                z,
                                new_shape[z],
                                order_z,
                            )
                        )
                        merged[onehot > 0.5] = lab
                    stacked = merged
            channels.append(stacked)
    else:
        for c in range(data.shape[0]):
            channels.append(resize_fn(data[c], new_shape, order))
    return np.stack(channels).astype(out_dtype)


def resample_data_or_seg_to_shape(
    data: np.ndarray,
    new_shape: Sequence[int],
    current_spacing: Sequence[float],
    new_spacing: Sequence[float],
    is_seg: bool = False,
    order: int = 3,
    order_z: int = 0,
    force_separate_z: bool | None = None,
    separate_z_anisotropy_threshold: float = ANISO_THRESHOLD,
) -> np.ndarray:
    """The plans-addressable entry point (kwargs == the plans' kwargs).

    Decides the separate-z dispatch from the spacings (unless forced), then
    delegates to :func:`resample_data_or_seg`. ``data`` is (C, *spatial);
    a bare (*spatial) seg is accepted and returned without the channel axis.
    """
    squeeze = False
    if data.ndim == len(new_shape):
        data = data[None]
        squeeze = True

    if force_separate_z is not None:
        do_separate_z = bool(force_separate_z)
        axis = get_lowres_axis(current_spacing) if force_separate_z else None
    elif get_do_separate_z(current_spacing, separate_z_anisotropy_threshold):
        do_separate_z = True
        axis = get_lowres_axis(current_spacing)
    elif get_do_separate_z(new_spacing, separate_z_anisotropy_threshold):
        do_separate_z = True
        axis = get_lowres_axis(new_spacing)
    else:
        do_separate_z = False
        axis = None

    # 2+ equally-lowres axes: near-isotropic; slice-wise would pick an
    # arbitrary axis, so fall back to full 3D resampling (substrate rule)
    if axis is not None and len(axis) > 1:
        do_separate_z = False

    out = resample_data_or_seg(
        data,
        new_shape,
        is_seg,
        axis=axis,
        order=order,
        do_separate_z=do_separate_z,
        order_z=order_z,
    )
    return out[0] if squeeze else out
