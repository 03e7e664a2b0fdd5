"""Synthetic preprocessed datasets for the measurement tools and
``chip_smoke.py``: a plans file, ``dataset.json`` and seeded cases in the
layout nnU-Net's preprocessing writes, for a network spec."""

from __future__ import annotations

import json
import os

import numpy as np

from nextou_tpu_torch.data.dataset import save_case


def write_dataset(folder: str, spec, configuration: str, cases: int, shape, seed: int,
                  labelled: bool = False):
    """A preprocessed dataset folder (plans, dataset.json, cases) for ``spec``,
    in the plans format nnU-Net writes; each case is ``{case}.npz`` with
    ``data`` (C, *sp) f32 and ``seg`` (*sp) int16, the preprocessed layout.
    Without ``labelled`` the labels are all background and the data noise;
    with it every label is present (regions of a coarse random partition,
    16 x 40 x 40 voxels a cell) and the data is the label's intensity plus
    noise, saved with the foreground locations the sampler oversamples."""
    cfg = {
        "batch_size": 2, "patch_size": list(spec.patch_size),
        "spacing": [1.0] * spec.spatial_dims,
        "normalization_schemes": ["CTNormalization"], "use_mask_for_norm": [False],
        "UNet_class_name": "PlainConvUNet",
        "UNet_base_num_features": spec.encoder[0].features,
        "unet_max_num_features": max(st.features for st in spec.encoder),
        "n_conv_per_stage_encoder": [st.n_conv + bool(st.gnn) for st in spec.encoder],
        "n_conv_per_stage_decoder": [st.n_conv + bool(st.gnn) for st in spec.decoder],
        "pool_op_kernel_sizes": [list(st.stride) for st in spec.encoder],
        "conv_kernel_sizes": [list(st.kernel_size) for st in spec.encoder],
        "batch_dice": True,
    }
    plans = {"dataset_name": "Dataset999_Smoke", "plans_name": "nnUNetPlans",
             "configurations": {configuration: cfg}}
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(plans, f)
    labels = {"background": 0, **{f"organ{i}": i for i in range(1, spec.num_classes)}}
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump({"labels": labels, "numTraining": cases, "channel_names": {"0": "CT"},
                   "file_ending": ".nii.gz"}, f)
    rng = np.random.default_rng(seed)
    for i in range(cases):
        if not labelled:
            np.savez(os.path.join(folder, f"case_{i:03d}.npz"),
                     data=rng.standard_normal((1, *shape), dtype=np.float32),
                     seg=np.zeros(shape, np.int16))
            continue
        data, seg = labelled_case(rng, shape, spec.num_classes)
        save_case(folder, f"case_{i:03d}", data[None], seg)


def labelled_case(rng, shape, num_classes: int):
    """``(data, seg)`` of ``shape``: every label present, in regions of a
    coarse random partition (16 x 40 x 40 voxels a cell), and the data the
    label's intensity plus noise."""
    cell = (16, 40, 40)
    coarse = rng.standard_normal((num_classes, *(-(-n // c) for n, c in zip(shape, cell))))
    seg = np.argmax(coarse, 0).astype(np.int16)
    for axis, c in enumerate(cell):
        seg = np.repeat(seg, c, axis=axis)
    seg = np.ascontiguousarray(seg[tuple(slice(0, n) for n in shape)])
    assert len(np.unique(seg)) == num_classes, "a label is missing"
    data = (seg / (num_classes - 1) - 0.5 + rng.normal(0, 0.3, shape)).astype(np.float32)
    return data, seg
