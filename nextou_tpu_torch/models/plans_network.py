"""The network spec a plans configuration describes, as the trainers build it:
NexToU whatever the plans name (the NexToU trainers, as the reference does,
``nnUNetTrainer_NexToU.py:31``), or the class the plans' ``UNet_class_name``
names (``nnUNetTrainer``: PlainConvUNet or ResidualEncoderUNet, whose
``n_blocks_per_stage`` are the plans' ``n_conv_per_stage_encoder``)."""

from __future__ import annotations

from nextou_tpu_torch.models.plain_unet import build_plain_unet_spec
from nextou_tpu_torch.models.residual_unet import build_residual_encoder_unet_spec
from nextou_tpu_torch.models.spec import ModelSpec, build_model_spec


def plans_network_spec(cm, in_channels: int, num_classes: int, deep_supervision: bool, *,
                       nextou: bool) -> ModelSpec:
    """``cm`` is the configuration's ``ConfigurationManager``; ``nextou``
    forces NexToU, else ``cm.UNet_class_name`` picks the network."""
    kwargs = dict(
        in_channels=in_channels, patch_size=cm.patch_size, n_stages=cm.num_stages,
        features_per_stage=cm.features_per_stage(), kernel_sizes=cm.conv_kernel_sizes,
        strides=cm.pool_op_kernel_sizes, n_conv_per_stage_decoder=cm.n_conv_per_stage_decoder,
        num_classes=num_classes, deep_supervision=deep_supervision,
    )
    name = "NexToU" if nextou else cm.UNet_class_name
    if name == "ResidualEncoderUNet":
        return build_residual_encoder_unet_spec(
            n_blocks_per_stage=cm.n_conv_per_stage_encoder, **kwargs)
    build = {"NexToU": build_model_spec, "PlainConvUNet": build_plain_unet_spec}.get(name)
    if build is None:
        raise ValueError(f"unknown UNet_class_name {name!r}")
    return build(n_conv_per_stage=cm.n_conv_per_stage_encoder, **kwargs)
