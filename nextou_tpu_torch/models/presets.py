"""Ready-made model specs for upstream NexToU's headline configurations,
carried over from ``nextou_tpu/models/presets.py`` (upstream
``nnUNetPlans.json:426-435`` for ``3d_fullres_nextou``).
"""

from __future__ import annotations

from nextou_tpu_torch.models.spec import ModelSpec, build_model_spec


def flagship_3d_spec(
    num_classes: int = 14,
    in_channels: int = 1,
    deep_supervision: bool = True,
) -> ModelSpec:
    """``3d_fullres_nextou``: patch 64x224x192, base 33 / max 324 features
    (BTCV multi-organ; 13 organs + background)."""
    return build_model_spec(
        in_channels=in_channels,
        patch_size=(64, 224, 192),
        n_stages=6,
        features_per_stage=[33, 66, 132, 264, 324, 324],
        kernel_sizes=[(1, 3, 3)] + [(3, 3, 3)] * 5,
        strides=[(1, 1, 1), (1, 2, 2)] + [(2, 2, 2)] * 4,
        n_conv_per_stage=[2] * 6,
        n_conv_per_stage_decoder=[2] * 5,
        num_classes=num_classes,
        deep_supervision=deep_supervision,
    )


def ravir_2d_spec(
    num_classes: int = 3,
    in_channels: int = 1,
    deep_supervision: bool = True,
) -> ModelSpec:
    """2D config (RAVIR retinal vessels): patch 512x448, 7 stages, base 32."""
    return build_model_spec(
        in_channels=in_channels,
        patch_size=(512, 448),
        n_stages=7,
        features_per_stage=[32, 64, 128, 256, 512, 512, 512],
        kernel_sizes=[(3, 3)] * 7,
        strides=[(1, 1)] + [(2, 2)] * 6,
        n_conv_per_stage=[2] * 7,
        n_conv_per_stage_decoder=[2] * 6,
        num_classes=num_classes,
        deep_supervision=deep_supervision,
    )


def small_3d_spec(
    num_classes: int = 3,
    in_channels: int = 1,
    deep_supervision: bool = True,
    features: tuple[int, ...] = (6, 12, 12, 12, 12, 12),
) -> ModelSpec:
    """A reduced 3D NexToU with the *same bottleneck schedule* as the
    flagship ((4,7,6) window, same k-list head) for CPU dry-runs and tests."""
    return build_model_spec(
        in_channels=in_channels,
        patch_size=(16, 112, 96),
        n_stages=6,
        features_per_stage=list(features),
        kernel_sizes=[(1, 3, 3)] + [(3, 3, 3)] * 5,
        strides=[
            (1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2), (1, 1, 1),
        ],
        n_conv_per_stage=[2] * 6,
        n_conv_per_stage_decoder=[2] * 5,
        num_classes=num_classes,
        deep_supervision=deep_supervision,
    )
