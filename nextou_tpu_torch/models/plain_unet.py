"""PlainConvUNet: the nnU-Net baseline architecture, counterpart of
``nextou_tpu/models/plain_unet.py``.

The plans name ``PlainConvUNet`` for the configurations that are not NexToU
(2d, 3d_lowres, 3d_fullres). It shares NexToU's interpreter: a PlainConvUNet
is a :class:`~nextou_tpu_torch.models.spec.ModelSpec` with no GNN blocks and
the full conv count per stage, under upstream's names
(``encoder.stages.{s}.0.convs.{j}``, ``decoder.stages.{s}.convs.{j}``,
``decoder.transpconvs.{s}``, ``decoder.seg_layers.{s}``).
"""

from __future__ import annotations

from typing import Sequence

from nextou_tpu_torch.models.nextou import NexToU
from nextou_tpu_torch.models.spec import DecoderStageSpec, ModelSpec, StageSpec, _stage_shapes


def build_plain_unet_spec(
    *,
    in_channels: int,
    patch_size: Sequence[int],
    n_stages: int,
    features_per_stage: Sequence[int],
    kernel_sizes: Sequence[Sequence[int]],
    strides: Sequence[Sequence[int]],
    n_conv_per_stage: Sequence[int],
    n_conv_per_stage_decoder: Sequence[int],
    num_classes: int,
    deep_supervision: bool = True,
) -> ModelSpec:
    shapes = _stage_shapes(patch_size, strides)
    encoder = tuple(
        StageSpec(
            features=features_per_stage[s], kernel_size=tuple(kernel_sizes[s]),
            stride=tuple(strides[s]), n_conv=n_conv_per_stage[s], img_shape=shapes[s],
        )
        for s in range(n_stages)
    )
    decoder = tuple(
        DecoderStageSpec(
            features=features_per_stage[-(s + 1)], transp_stride=tuple(strides[-s]),
            kernel_size=tuple(kernel_sizes[-(s + 1)]), n_conv=n_conv_per_stage_decoder[s - 1],
            img_shape=shapes[n_stages - (s + 1)],
        )
        for s in range(1, n_stages)
    )
    dims = len(patch_size)
    return ModelSpec(
        spatial_dims=dims, in_channels=in_channels, num_classes=num_classes,
        patch_size=tuple(patch_size), encoder=encoder, decoder=decoder,
        groups=4 if dims == 2 else 6, deep_supervision=deep_supervision,
    )


class PlainConvUNet(NexToU):
    """The same interpreter on a conv-only spec; a class of its own so that
    the network is chosen by the plans' name, as upstream maps it."""
