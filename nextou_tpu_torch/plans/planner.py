"""Experiment planning: dataset fingerprint -> nnUNetPlans-compatible plans.

Counterpart of ``nextou_tpu/plans/planner.py`` (numpy only): given a dataset
fingerprint (:mod:`nextou_tpu_torch.plans.fingerprint`), derive the ``2d`` /
``3d_fullres`` / ``3d_lowres`` / ``3d_cascade_fullres`` configurations plus
the NexToU overlay configurations (``3d_fullres_nextou``, ``2d_nextou``),
whose channel counts satisfy the graph stages' divisibility (base 33 / max
324 from nnU-Net's 32 / 320). The same fingerprint gives the same plans, key
for key, as the JAX package's planner.

The rules are nnU-Net v2.0's ExperimentPlanner's, and so are the constants
below: the 560e6 / 85e6 feature-map budget of nnU-Net's reference GPU, not
this card's memory, so that a user gets the plans nnU-Net would give. With
the estimate of :func:`compute_conv_feature_map_size`, BTCV's fingerprint
medians give patch [64, 192, 160] / pools [4, 5, 5] / batch 2
(3d_fullres) and [64, 224, 192] with 33 / 324 (3d_fullres_nextou), the
flagship. The trainer also reads the estimate to choose its recomputation
(``train/trainer.py``).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np

# Planning constants (nnU-Net v2.0 ExperimentPlanner defaults; they
# reproduce upstream NexToU's shipped BTCV plans, see the module docstring).
UNET_REFERENCE_VAL_3D = 560_000_000
UNET_REFERENCE_VAL_2D = 85_000_000
UNET_REFERENCE_BS_3D = 2
UNET_REFERENCE_BS_2D = 12
UNET_BASE_FEATURES = 32
UNET_MAX_FEATURES_3D = 320
UNET_MAX_FEATURES_2D = 512
UNET_MIN_EDGE = 4  # smallest allowed feature-map edge at the bottleneck
UNET_MIN_BATCH = 2
MAX_DATASET_COVERAGE_PER_BATCH = 0.05
ANISO_THRESHOLD = 3.0
LOWRES_PATCH_COVERAGE = 0.25  # lowres patch must cover >= 1/4 of median case


def determine_fullres_target_spacing(
    spacings: np.ndarray, shapes_after_crop: np.ndarray
) -> list[float]:
    """Median spacing per axis; for strongly anisotropic data (worst axis
    spacing > 3x the best and proportionally few voxels) use that axis's
    10th-percentile spacing instead."""
    spacings = np.asarray(spacings, np.float64)
    shapes = np.asarray(shapes_after_crop, np.float64)
    target = np.percentile(spacings, 50, axis=0)
    target_size = np.percentile(shapes, 50, axis=0)
    worst = int(np.argmax(target))
    other = [i for i in range(len(target)) if i != worst]
    if other:
        other_sp = [target[i] for i in other]
        other_sz = [target_size[i] for i in other]
        # nnU-Net v2 compares against max(other_spacings) (and min of the
        # other *sizes*); the clamp likewise never lets the worst axis end
        # up finer than the coarsest remaining axis
        aniso_spacing = target[worst] > ANISO_THRESHOLD * max(other_sp)
        aniso_voxels = target_size[worst] * ANISO_THRESHOLD < min(other_sz)
        if aniso_spacing and aniso_voxels:
            t = float(np.percentile(spacings[:, worst], 10))
            if t < max(other_sp):
                t = max(max(other_sp), t) + 1e-5
            target[worst] = t
    return [float(t) for t in target]


def determine_transpose(target_spacing: Sequence[float]) -> tuple[list[int], list[int]]:
    """Anisotropic (largest-spacing) axis first; inverse for writing back."""
    worst = int(np.argmax(target_spacing))
    fwd = [worst] + [i for i in range(len(target_spacing)) if i != worst]
    bwd = [fwd.index(i) for i in range(len(fwd))]
    return fwd, bwd


def get_pool_and_conv_props(
    spacing: Sequence[float],
    patch_size: Sequence[int],
    min_edge: int = UNET_MIN_EDGE,
    max_numpool: int = 999,
):
    """Per-stage pooling strides and conv kernel sizes from spacing + patch.

    Pools every axis whose current spacing is within a factor 2 of the finest
    current spacing and whose size can still halve above ``min_edge``; conv
    kernels start at 1 on coarse axes and switch to 3 once the axis joins.
    Returns (num_pool_per_axis, pool_kernels, conv_kernels, padded_patch,
    must_be_divisible_by).
    """
    dim = len(spacing)
    cur_sp = [float(s) for s in spacing]
    cur_sz = [int(p) for p in patch_size]
    pool_kernels: list[list[int]] = [[1] * dim]
    conv_kernels: list[list[int]] = []
    num_pool = [0] * dim
    kernel = [1] * dim
    while True:
        valid = [i for i in range(dim) if cur_sz[i] >= 2 * min_edge]
        if valid:
            min_sp = min(cur_sp[i] for i in valid)
            valid = [i for i in valid if cur_sp[i] / min_sp < 2]
        valid = [i for i in valid if num_pool[i] < max_numpool]
        if len(valid) == 1 and cur_sz[valid[0]] < 3 * min_edge:
            break
        if not valid:
            break
        overall_min = min(cur_sp)
        for d in range(dim):
            if kernel[d] != 3 and cur_sp[d] / overall_min < 2:
                kernel[d] = 3
        step = [1] * dim
        for v in valid:
            step[v] = 2
            num_pool[v] += 1
            cur_sp[v] *= 2.0
            cur_sz[v] = math.ceil(cur_sz[v] / 2)
        pool_kernels.append(step)
        conv_kernels.append(list(kernel))
    divisible = [2 ** p for p in num_pool]
    padded = [
        int(math.ceil(p / d) * d) for p, d in zip(patch_size, divisible)
    ]
    conv_kernels.append([3] * dim)  # bottleneck stage always 3^d
    return num_pool, pool_kernels, conv_kernels, padded, divisible


def features_per_stage(n_stages: int, base: int, max_features: int) -> list[int]:
    return [min(base * 2 ** i, max_features) for i in range(n_stages)]


def compute_conv_feature_map_size(
    patch_size: Sequence[int],
    features: Sequence[int],
    pool_kernels: Sequence[Sequence[int]],
    n_conv_enc: Sequence[int],
    n_conv_dec: Sequence[int],
    num_classes: int = 0,
) -> int:
    """Total conv output elements of a PlainConv U-Net forward (the VRAM
    proxy nnU-Net's planner compares against its reference budget):
    encoder conv outputs + decoder transpconv/conv outputs + the final
    full-resolution segmentation head (deep-supervision heads excluded: the
    shipped plans' patch and batch sizes reproduce only with exactly this
    accounting)."""
    sizes = []
    cur = list(patch_size)
    total = 0
    for s, stride in enumerate(pool_kernels):
        cur = [math.ceil(c / st) for c, st in zip(cur, stride)]
        sizes.append(list(cur))
        total += n_conv_enc[s] * features[s] * math.prod(cur)
    n_stages = len(pool_kernels)
    for t in range(n_stages - 1):
        skip = sizes[n_stages - 2 - t]
        f = features[n_stages - 2 - t]
        vox = math.prod(skip)
        total += f * vox  # transposed conv output
        total += n_conv_dec[t] * f * vox
    total += num_classes * math.prod(sizes[0])  # final seg head
    return total


def _initial_patch_size(
    spacing: Sequence[float], median_shape: Sequence[float]
) -> list[int]:
    tmp = 1.0 / np.asarray(spacing, np.float64)
    dim = len(spacing)
    vol = 256 ** 3 if dim == 3 else 2048 ** 2
    init = tmp * (vol / np.prod(tmp)) ** (1.0 / dim)
    init = np.minimum(np.round(init), np.asarray(median_shape[:dim]))
    return [int(i) for i in init]


def plan_configuration(
    spacing: Sequence[float],
    median_shape: Sequence[float],
    approx_dataset_voxels: float,
    num_classes: int,
    *,
    n_conv_per_stage: int = 2,
) -> dict[str, Any]:
    """Derive one configuration: patch size, network topology, batch size."""
    dim = len(spacing)
    base = UNET_BASE_FEATURES
    max_f = UNET_MAX_FEATURES_3D if dim == 3 else UNET_MAX_FEATURES_2D
    reference = UNET_REFERENCE_VAL_3D if dim == 3 else UNET_REFERENCE_VAL_2D
    ref_bs = UNET_REFERENCE_BS_3D if dim == 3 else UNET_REFERENCE_BS_2D

    patch = _initial_patch_size(spacing, median_shape)
    num_pool, pools, kernels, patch, divisible = get_pool_and_conv_props(
        spacing, patch
    )

    def estimate(patch, pools):
        n_stages = len(pools)
        feats = features_per_stage(n_stages, base, max_f)
        return compute_conv_feature_map_size(
            patch, feats, pools,
            [n_conv_per_stage] * n_stages, [n_conv_per_stage] * (n_stages - 1),
            num_classes=num_classes,
        )

    est = estimate(patch, pools)
    while est > reference:
        # shrink the axis largest relative to the median shape by one
        # stride multiple, then re-derive the topology
        rel = [p / m for p, m in zip(patch, median_shape[:dim])]
        ax = int(np.argsort(rel)[-1])
        tmp = list(patch)
        tmp[ax] -= divisible[ax]
        _, _, _, _, div2 = get_pool_and_conv_props(spacing, tmp)
        patch = list(patch)
        patch[ax] -= div2[ax]
        num_pool, pools, kernels, patch, divisible = get_pool_and_conv_props(
            spacing, patch
        )
        est = estimate(patch, pools)

    batch_size = round(reference / est * ref_bs)
    cap = max(
        round(
            MAX_DATASET_COVERAGE_PER_BATCH
            * approx_dataset_voxels
            / float(np.prod(patch))
        ),
        UNET_MIN_BATCH,
    )
    batch_size = max(min(batch_size, cap), UNET_MIN_BATCH)

    n_stages = len(pools)
    return {
        "batch_size": int(batch_size),
        "patch_size": [int(p) for p in patch],
        "median_image_size_in_voxels": [float(m) for m in median_shape[:dim]],
        "spacing": [float(s) for s in spacing],
        "UNet_class_name": "PlainConvUNet",
        "UNet_base_num_features": base,
        "n_conv_per_stage_encoder": [n_conv_per_stage] * n_stages,
        "n_conv_per_stage_decoder": [n_conv_per_stage] * (n_stages - 1),
        "num_pool_per_axis": [int(p) for p in num_pool],
        "pool_op_kernel_sizes": [list(p) for p in pools],
        "conv_kernel_sizes": [list(k) for k in kernels],
        "unet_max_num_features": max_f,
    }


def nextou_feature_constraints(
    dim: int, base: int, max_features: int, first_gnn_stage: int = 2
):
    """Round base/max features up so every GNN-stage channel count divides
    the grouped-conv groups (6 in 3D, 4 in 2D; upstream NexToU's
    ``torch_nn.py:73-85``) and satisfies the sin-cos embedding constraints
    (3D: dim%3==0 with dim/3 even -> %6; 2D: dim%2==0 with dim/2 even -> %4;
    upstream ``pos_embed.py:85-111``). Gives upstream's 33/324 from
    nnU-Net's 32/320. ``first_gnn_stage`` is
    ``max(0, n_stages - 4)``: GNN-stage features are ``base * 2^i`` so the
    divisibility requirement on ``base`` weakens with each leading conv-only
    stage (e.g. six stages -> i >= 2 -> base % 3 suffices)."""
    div = 6 if dim == 3 else 4
    need = div
    for _ in range(first_gnn_stage):
        need = need if need % 2 else need // 2
        if need == 1:
            break
    b = base
    while b % need != 0:
        b += 1
    m = max_features
    while m % div != 0:
        m += 1
    return b, m


def nextou_overlay(
    config: dict[str, Any], inherits: str, median_shape: Sequence[float]
) -> dict[str, Any]:
    """The NexToU variant of a planned configuration: adjusted channel
    counts and a patch enlarged by one stride-multiple per axis (capped at
    the median image size) so the bottleneck graph has more nodes —
    reproducing upstream's [64,192,160] -> [64,224,192] and 32/320 ->
    33/324 overrides (upstream ``nnUNetPlans.json:426-435``)."""
    dim = len(config["patch_size"])
    n_stages = len(config["pool_op_kernel_sizes"])
    base, max_f = nextou_feature_constraints(
        dim,
        config["UNet_base_num_features"],
        config["unet_max_num_features"],
        first_gnn_stage=max(0, n_stages - 4),
    )
    divisible = [2 ** p for p in config["num_pool_per_axis"]]
    patch = []
    for ax, (p, d) in enumerate(zip(config["patch_size"], divisible)):
        grown = p + d
        m = median_shape[ax]
        # only grow in-plane axes with room in the median image: in 3D the
        # leading (z / worst-spacing) axis stays, in 2D both axes are
        # in-plane and may grow
        if (dim == 2 or ax > 0) and grown <= math.ceil(m / d) * d:
            patch.append(int(grown))
        else:
            patch.append(int(p))
    out: dict[str, Any] = {"inherits_from": inherits}
    if patch != list(config["patch_size"]):
        out["patch_size"] = patch
    if base != config["UNet_base_num_features"]:
        out["UNet_base_num_features"] = base
    if max_f != config["unet_max_num_features"]:
        out["unet_max_num_features"] = max_f
    out["UNet_class_name"] = "NexToU"
    return out


def _normalization_for(channel_names: dict, fingerprint: dict):
    schemes, masks = [], []
    crop_ratio = fingerprint.get("median_relative_size_after_cropping", 1.0)
    for _k, name in sorted(channel_names.items(), key=lambda kv: int(kv[0])):
        if str(name).upper() == "CT":
            schemes.append("CTNormalization")
            masks.append(False)
        else:
            schemes.append("ZScoreNormalization")
            masks.append(bool(crop_ratio < 0.75))
    return schemes, masks


def plan_experiment(
    fingerprint: dict[str, Any],
    dataset_json: dict[str, Any],
    *,
    dataset_name: str = "",
    plans_name: str = "nnUNetPlans",
) -> dict[str, Any]:
    """Full planning: fingerprint + dataset.json -> plans dict with the same
    schema as upstream's ``nnUNetPlans.json`` (loadable by
    :class:`nextou_tpu_torch.plans.PlansManager` and by nnU-Net itself)."""
    spacings = np.asarray(fingerprint["spacings"], np.float64)
    shapes = np.asarray(fingerprint["shapes_after_crop"], np.float64)
    n_cases = len(spacings)
    num_classes = len(dataset_json["labels"])
    channel_names = dataset_json.get(
        "channel_names", dataset_json.get("modality", {"0": "noNorm"})
    )

    target = determine_fullres_target_spacing(spacings, shapes)
    fwd, bwd = determine_transpose(target)
    spacings_t = spacings[:, fwd]
    shapes_t = shapes[:, fwd]
    target_t = [target[i] for i in fwd]

    new_shapes = shapes_t * spacings_t / np.asarray(target_t)
    median_shape = np.percentile(new_shapes, 50, axis=0).tolist()
    orig_median_shape = np.percentile(shapes_t, 50, axis=0).tolist()
    orig_median_spacing = np.percentile(spacings_t, 50, axis=0).tolist()
    dataset_voxels = float(np.prod(median_shape)) * n_cases

    schemes, masks = _normalization_for(channel_names, fingerprint)

    def finish(cfg: dict, ident: str, batch_dice: bool) -> dict:
        cfg = dict(cfg)
        cfg.update(
            data_identifier=f"{plans_name}_{ident}",
            preprocessor_name="DefaultPreprocessor",
            normalization_schemes=schemes,
            use_mask_for_norm=masks,
            resampling_fn_data="resample_data_or_seg_to_shape",
            resampling_fn_data_kwargs={
                "is_seg": False, "order": 3, "order_z": 0,
                "force_separate_z": None,
            },
            resampling_fn_seg="resample_data_or_seg_to_shape",
            resampling_fn_seg_kwargs={
                "is_seg": True, "order": 1, "order_z": 0,
                "force_separate_z": None,
            },
            resampling_fn_probabilities="resample_data_or_seg_to_shape",
            resampling_fn_probabilities_kwargs={
                "is_seg": False, "order": 1, "order_z": 0,
                "force_separate_z": None,
            },
            batch_dice=batch_dice,
        )
        return cfg

    configs: dict[str, Any] = {}

    # ---- 2d: in-plane spacing/shape -------------------------------------
    cfg_2d = plan_configuration(
        target_t[1:], median_shape[1:], dataset_voxels, num_classes
    )
    # a 2d batch of slices covers a tiny fraction of a 3d case
    configs["2d"] = finish(cfg_2d, "2d", batch_dice=True)

    # ---- 3d_fullres ------------------------------------------------------
    cfg_fr = plan_configuration(
        target_t, median_shape, dataset_voxels, num_classes
    )
    fr_cover = float(np.prod(cfg_fr["patch_size"])) / float(
        np.prod(median_shape)
    )
    configs["3d_fullres"] = finish(
        cfg_fr, "3d_fullres", batch_dice=fr_cover < LOWRES_PATCH_COVERAGE
    )

    # ---- 3d_lowres: raise spacing until the patch covers >= 1/4 ----------
    cfg_lr = None
    if fr_cover < LOWRES_PATCH_COVERAGE:
        lr_spacing = list(target_t)
        cfg_lr = cfg_fr
        lr_shape = list(median_shape)
        max_iters = 10_000  # 1.01^10000 >> any real spacing ratio: a pure
        # convergence backstop that turns a coarsening-loop regression into
        # an error instead of an infinite hang
        while (
            float(np.prod(lr_shape)) / float(np.prod(cfg_lr["patch_size"]))
            > 1.0 / LOWRES_PATCH_COVERAGE
        ):
            max_iters -= 1
            if max_iters < 0:
                raise RuntimeError(
                    "3d_lowres spacing search failed to converge "
                    f"(spacing {lr_spacing}, shape {lr_shape})"
                )
            mx = max(lr_spacing)
            finer = [s < mx / 2 for s in lr_spacing]
            if any(finer):
                # only coarsen the finer axes until roughly isotropic
                lr_spacing = [
                    s * 1.01 if f else s for s, f in zip(lr_spacing, finer)
                ]
            else:
                # no axis is under half the max (incl. ratio EXACTLY 2):
                # coarsen all, or the loop never makes progress (nnU-Net's
                # any/else structure)
                lr_spacing = [s * 1.01 for s in lr_spacing]
            lr_shape = [
                m * t / s
                for m, t, s in zip(median_shape, target_t, lr_spacing)
            ]
            cfg_lr = plan_configuration(
                lr_spacing,
                lr_shape,
                float(np.prod(lr_shape)) * n_cases,
                num_classes,
            )
        lr_cover = float(np.prod(cfg_lr["patch_size"])) / float(
            np.prod(lr_shape)
        )
        cfg_lr["median_image_size_in_voxels"] = [
            round(s) for s in lr_shape
        ]
        configs["3d_lowres"] = finish(
            cfg_lr, "3d_lowres", batch_dice=lr_cover < LOWRES_PATCH_COVERAGE
        )
        configs["3d_lowres"]["next_stage"] = "3d_cascade_fullres"
        configs["3d_cascade_fullres"] = {
            "inherits_from": "3d_fullres",
            "previous_stage": "3d_lowres",
        }

    # ---- NexToU overlays --------------------------------------------------
    # NexToU needs >= 5 stages (the first reduce_ratio=16 Pool-GNN stage
    # must sit at a downsampled resolution; all of upstream's configurations
    # satisfy this): no overlay for tiny-image datasets.
    if len(cfg_fr["pool_op_kernel_sizes"]) >= 5:
        configs["3d_fullres_nextou"] = nextou_overlay(
            cfg_fr, "3d_fullres", median_shape
        )
    if len(cfg_2d["pool_op_kernel_sizes"]) >= 5:
        configs["2d_nextou"] = nextou_overlay(cfg_2d, "2d", median_shape[1:])

    return {
        "dataset_name": dataset_name or dataset_json.get("name", ""),
        "plans_name": plans_name,
        "original_median_spacing_after_transp": orig_median_spacing,
        "original_median_shape_after_transp": [
            round(s) for s in orig_median_shape
        ],
        "image_reader_writer": "NiftiIO",
        "transpose_forward": fwd,
        "transpose_backward": bwd,
        "configurations": configs,
        "experiment_planner_used": "ExperimentPlanner",
        "label_manager": "LabelManager",
        "foreground_intensity_properties_per_channel": fingerprint.get(
            "foreground_intensity_properties_per_channel", {}
        ),
    }
