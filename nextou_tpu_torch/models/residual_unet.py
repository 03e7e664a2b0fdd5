"""ResidualEncoderUNet: nnU-Net's residual-encoder U-Net, counterpart of
``nextou_tpu/models/residual_unet.py``.

A stride-1 stem conv block to ``features_per_stage[0]`` (``encoder.stem``),
encoder stages of residual blocks (``n_blocks_per_stage``, the plans'
``n_conv_per_stage_encoder``; the first block of a stage strided, its last
norm starting at 0: ``encoder.stages.{s}.0.blocks.{b}``, see
``nn/conv_blocks.py``), and PlainConvUNet's decoder and deep-supervision
heads. The blocks' skip is the JAX package's strided 1x1 conv + norm, not
upstream ``BasicBlockD``'s average pool + 1x1 conv, and upstream registers
its stages without the ``.0`` level: an upstream ResEnc checkpoint does not
load here as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from nextou_tpu_torch.models.nextou import NexToU
from nextou_tpu_torch.models.plain_unet import build_plain_unet_spec
from nextou_tpu_torch.models.spec import ModelSpec


def build_residual_encoder_unet_spec(
    *,
    in_channels: int,
    patch_size: Sequence[int],
    n_stages: int,
    features_per_stage: Sequence[int],
    kernel_sizes: Sequence[Sequence[int]],
    strides: Sequence[Sequence[int]],
    n_blocks_per_stage: Sequence[int],
    n_conv_per_stage_decoder: Sequence[int],
    num_classes: int,
    deep_supervision: bool = True,
) -> ModelSpec:
    spec = build_plain_unet_spec(
        in_channels=in_channels, patch_size=patch_size, n_stages=n_stages,
        features_per_stage=features_per_stage, kernel_sizes=kernel_sizes, strides=strides,
        n_conv_per_stage=n_blocks_per_stage, n_conv_per_stage_decoder=n_conv_per_stage_decoder,
        num_classes=num_classes, deep_supervision=deep_supervision,
    )
    encoder = tuple(dataclasses.replace(st, residual=True) for st in spec.encoder)
    return dataclasses.replace(spec, encoder=encoder, stem_features=features_per_stage[0])


class ResidualEncoderUNet(NexToU):
    """The same interpreter on a residual-encoder spec; a class of its own so
    that the network is chosen by the plans' name, as upstream maps it."""
