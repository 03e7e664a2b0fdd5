"""Synthetic data for the measurement tools, ``chip_smoke.py`` and the tests:
a plans file, ``dataset.json`` and seeded cases in the layout nnU-Net's
preprocessing writes, for a network spec; RAVIR-like retinal vessel maps and
images; and the narrow network of the RAVIR schedule."""

from __future__ import annotations

import json
import os

import numpy as np

from nextou_tpu_torch.data.dataset import save_case

# RAVIR's dataset.json: 23 single-channel infrared training images, labels
# background, artery and vein
RAVIR_DATASET_JSON = {"labels": {"background": 0, "artery": 1, "vein": 2}, "numTraining": 23,
                      "channel_names": {"0": "infrared"}, "file_ending": ".nii.gz"}

# ravir_2d_spec's seven stages, kernel sizes and strides at narrow widths (every
# grapher's width divisible by 4 and 4; the first GNN stage half as wide as the
# others, as 256 to 512 in the preset), at a patch whose bottleneck keeps 4 x 4
# = 16 nodes. At 8 and 16 channels the selections hold near ties of 1.8e-7
# (the first pooled grapher) and 1.3e-6 (the decoder's 16 x 16 one) that two
# f32 sums in another order split differently: 1.9% of the 32 x 32 head's
# values then part by up to 0.07. At 16 and 32 every head of the JAX package
# and the port agrees within the port's own floor (its weights x (1 +- 1e-6):
# 4.8e-5 at most).
NARROW_RAVIR_2D = dict(
    in_channels=1, patch_size=(256, 256), n_stages=7,
    features_per_stage=[4, 8, 8, 16, 32, 32, 32], kernel_sizes=[(3, 3)] * 7,
    strides=[(1, 1)] + [(2, 2)] * 6, n_conv_per_stage=[2] * 7,
    n_conv_per_stage_decoder=[2] * 6, num_classes=3,
)


def plans_for(spec, configuration: str, batch_size: int = 2) -> dict:
    """A plans file, in the format nnU-Net writes, whose ``configuration``
    describes ``spec``."""
    cfg = {
        "batch_size": batch_size, "patch_size": list(spec.patch_size),
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
    return {"dataset_name": "Dataset999_Smoke", "plans_name": "nnUNetPlans",
            "configurations": {configuration: cfg}}


def write_dataset(folder: str, spec, configuration: str, cases: int, shape, seed: int,
                  labelled: bool = False):
    """A preprocessed dataset folder (plans, dataset.json, cases) for ``spec``,
    in the plans format nnU-Net writes; each case is ``{case}.npz`` with
    ``data`` (C, *sp) f32 and ``seg`` (*sp) int16, the preprocessed layout.
    Without ``labelled`` the labels are all background and the data noise;
    with it every label is present (regions of a coarse random partition,
    16 x 40 x 40 voxels a cell) and the data is the label's intensity plus
    noise, saved with the foreground locations the sampler oversamples."""
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(plans_for(spec, configuration), f)
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


def vessel_map(rng, shape) -> np.ndarray:
    """RAVIR-like labels of an (H, W) image: veins (2), then arteries (1) over
    them, each a few bent chords across the field, 3-7 px wide, so that the two
    cross."""
    H, W = shape
    seg = np.zeros(shape, np.int16)
    for label in (2, 1):
        for _ in range(int(rng.integers(4, 7))):
            a, b = rng.uniform(0, 2 * np.pi, 2)
            p0 = np.array([H / 2 + 0.6 * H * np.sin(a), W / 2 + 0.6 * W * np.cos(a)])
            p1 = np.array([H / 2 + 0.6 * H * np.sin(b), W / 2 + 0.6 * W * np.cos(b)])
            length = max(np.linalg.norm(p1 - p0), 1.0)
            t = np.linspace(0, 1, int(2 * length) + 2)[:, None]
            d = (p1 - p0) / length
            amp, freq, phase = rng.uniform(0.03, 0.1) * H, rng.uniform(1, 3), rng.uniform(0, 2 * np.pi)
            pts = p0 + t * (p1 - p0) + np.array([-d[1], d[0]]) * (
                amp * np.sin(2 * np.pi * freq * t + phase))
            r = rng.uniform(1.5, 3.5)
            ri = int(np.ceil(r))
            oy, ox = np.mgrid[-ri:ri + 1, -ri:ri + 1]
            disk = oy ** 2 + ox ** 2 <= r * r
            c = np.round(pts).astype(np.int64)
            yy, xx = (c[:, :1] + oy[disk]).ravel(), (c[:, 1:] + ox[disk]).ravel()
            inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
            seg[yy[inside], xx[inside]] = label
    return seg


def retina_image(rng, seg) -> np.ndarray:
    """An infrared-like f32 image of ``seg``: arteries bright, veins dark, noise."""
    return (100 + 40 * (seg == 1) - 40 * (seg == 2) + rng.normal(0, 15, seg.shape)).astype(np.float32)


def vessel_batch(rng, batch: int, shape) -> dict:
    """A train batch of ``batch`` vessel maps of ``shape``: ``data`` (B, *shape,
    1) normalized f32, ``seg`` (B, *shape) int64."""
    seg = np.stack([vessel_map(rng, shape) for _ in range(batch)])
    data = (retina_image(rng, seg) - 100) / 40
    return {"data": data[..., None], "seg": seg.astype(np.int64)}
