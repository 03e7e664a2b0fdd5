"""Raw-image inference: the full predict_from_raw_data pipeline.

Counterpart of ``nextou_tpu/infer/raw.py`` (host code: numpy and scipy
around a predictor). Read raw NIfTI channels, transpose, crop to nonzero,
normalize per the plans' schemes, resample to the configuration's spacing,
sliding-window predict, resample the probabilities back (order 1), argmax,
revert the crop and transpose, and write the segmentation at the original
geometry.
"""

from __future__ import annotations

import os
from typing import Callable, Sequence

import numpy as np

from nextou_tpu_torch.data.io import read_image, write_nifti
from nextou_tpu_torch.data.preprocessing import (
    crop_to_nonzero,
    normalize,
    resample_to_shape,
    shape_for_spacing,
)
from nextou_tpu_torch.data.resampling import resample_data_or_seg_to_shape


def predict_raw_case(
    predictor: Callable[[np.ndarray], np.ndarray],
    images: np.ndarray,
    spacing: Sequence[float],
    *,
    target_spacing: Sequence[float],
    normalization_schemes: list[str] | None,
    use_mask_for_norm: list[bool] | None,
    intensity_props: dict | None,
    transpose_forward: Sequence[int] | None = None,
    transpose_backward: Sequence[int] | None = None,
    prev_onehot: np.ndarray | None = None,
    prev_onehot_loader: Callable[[tuple], np.ndarray] | None = None,
    label_manager=None,
    resampling_data_kwargs: dict | None = None,
    resampling_probabilities_kwargs: dict | None = None,
) -> np.ndarray:
    """images: (C, *sp) raw; returns (*sp) int16 seg at original geometry.

    ``prev_onehot``: optional cascade channels (F, *preprocessed_sp) already
    on the preprocessed grid, appended after normalization/resampling.
    ``prev_onehot_loader``: alternative for callers that cannot know the
    preprocessed grid up front — called with the resampled spatial shape,
    must return (F, *that_shape); ``predict -prev --raw`` passes this one.
    """
    spacing = list(spacing)
    if transpose_forward:
        images = np.transpose(images, [0] + [a + 1 for a in transpose_forward])
        spacing = [spacing[a] for a in transpose_forward]
    orig_shape = images.shape[1:]

    cropped, _, bbox = crop_to_nonzero(images, None)
    shape_after_crop = cropped.shape[1:]
    data = normalize(
        cropped,
        normalization_schemes,
        use_mask_for_norm,
        intensity_props,
    )
    tgt = list(target_spacing)
    if len(tgt) == len(orig_shape) - 1:  # 2d configuration on 3d volume
        tgt = [spacing[0]] + tgt
    new_shape = shape_for_spacing(shape_after_crop, spacing, tgt)
    if resampling_data_kwargs is not None:
        data = resample_data_or_seg_to_shape(
            data, new_shape, spacing, tgt, is_seg=False,
            **resampling_data_kwargs,
        )
    else:
        data = np.stack(
            [resample_to_shape(c, new_shape, order=3) for c in data]
        )

    x = np.moveaxis(data, 0, -1)
    if prev_onehot is None and prev_onehot_loader is not None:
        prev_onehot = prev_onehot_loader(tuple(new_shape))
    if prev_onehot is not None:
        x = np.concatenate(
            [x, np.moveaxis(prev_onehot, 0, -1).astype(np.float32)], axis=-1
        )
    probs = predictor(x)  # (*new_shape, num_classes)

    # resample probabilities back to the cropped grid (plans' probabilities
    # kwargs — order 1 + separate-z dispatch; spacing roles swap on the way
    # back: current = configuration spacing, new = original spacing)
    if tuple(new_shape) != tuple(shape_after_crop):
        if resampling_probabilities_kwargs is not None:
            probs = np.moveaxis(
                resample_data_or_seg_to_shape(
                    np.moveaxis(probs, -1, 0),
                    shape_after_crop,
                    tgt,
                    spacing,
                    is_seg=False,
                    **resampling_probabilities_kwargs,
                ),
                0,
                -1,
            )
        else:
            probs = np.stack(
                [
                    resample_to_shape(probs[..., c], shape_after_crop, order=1)
                    for c in range(probs.shape[-1])
                ],
                axis=-1,
            )
    if label_manager is not None:
        seg_crop = label_manager.convert_probabilities_to_segmentation(probs)
    else:
        seg_crop = np.argmax(probs, axis=-1).astype(np.int16)

    # revert crop
    seg = np.zeros(orig_shape, np.int16)
    seg[tuple(slice(a, b) for a, b in bbox)] = seg_crop
    if transpose_backward:
        seg = np.transpose(seg, transpose_backward)
    return seg


def predict_raw_folder(
    predictor,
    input_folder: str,
    output_folder: str,
    plans_manager,
    configuration_manager,
    dataset_json: dict,
    cases: list[str] | None = None,
    prev_seg_loader: Callable[[str, tuple], np.ndarray] | None = None,
    verbose: bool = True,
    postprocess: Callable[[np.ndarray], np.ndarray] | None = None,
) -> list[str]:
    """Predict every case of a raw folder (``{case}_{0000..}.nii.gz``
    layout, or ``{case}.nii.gz`` single-channel) and write
    ``{case}.nii.gz`` segmentations at the original geometry. With
    ``verbose`` each case's line names the accumulation path the predictor
    took, where it records one (``predictor.path``)."""
    ending = dataset_json.get("file_ending", ".nii.gz")
    channels = dataset_json.get(
        "channel_names", dataset_json.get("modality", {"0": "noNorm"})
    )
    n_ch = len(channels)
    def _case_of(stem: str) -> str:
        # strip only nnU-Net's channel convention: a 4-digit _0000 suffix.
        # A looser any-digits rule misparses single-channel names like
        # patient_01.nii.gz into 'patient'.
        head, _, tail = stem.rpartition("_")
        return head if head and len(tail) == 4 and tail.isdigit() else stem

    if cases is None:
        cases = sorted(
            {
                _case_of(f[: -len(ending)])
                for f in os.listdir(input_folder)
                if f.endswith(ending)
            }
        )
    os.makedirs(output_folder, exist_ok=True)
    plans = plans_manager.plans
    intensity = plans.get("foreground_intensity_properties_per_channel", {})
    written = []
    for cid in cases:
        chans, spacing = [], None
        for c in range(n_ch):
            p = os.path.join(input_folder, f"{cid}_{c:04d}{ending}")
            if not os.path.exists(p) and n_ch == 1:
                p = os.path.join(input_folder, f"{cid}{ending}")
            arr, sp = read_image(p)
            # 4D-singleton storage (same squeeze as integrity/fingerprint)
            chans.append(arr[0] if arr.ndim == 4 else arr)
            spacing = sp or spacing
        images = np.stack(chans)
        if not spacing:
            spacing = (1.0,) * images[0].ndim
        seg = predict_raw_case(
            predictor,
            images,
            spacing,
            target_spacing=configuration_manager.spacing,
            normalization_schemes=configuration_manager.normalization_schemes
            or None,
            use_mask_for_norm=configuration_manager.use_mask_for_norm or None,
            intensity_props=intensity,
            transpose_forward=plans_manager.transpose_forward or None,
            transpose_backward=plans_manager.transpose_backward or None,
            prev_onehot_loader=(
                None
                if prev_seg_loader is None
                else (lambda shape, _cid=cid: prev_seg_loader(_cid, shape))
            ),
            label_manager=plans_manager.get_label_manager(dataset_json),
            resampling_data_kwargs=(
                configuration_manager.resampling_fn_data_kwargs
            ),
            resampling_probabilities_kwargs=(
                configuration_manager.resampling_fn_probabilities_kwargs
            ),
        )
        if postprocess is not None:
            seg = postprocess(seg)
        out = os.path.join(output_folder, f"{cid}{ending}")
        write_nifti(out, seg, spacing=spacing)
        written.append(out)
        if verbose:
            path = getattr(predictor, "path", None)
            print(f"predicted {cid}: {seg.shape} -> {out}" + (f" ({path})" if path else ""))
    return written
