from nextou_tpu_torch.models.nextou import NexToU
from nextou_tpu_torch.models.plain_unet import PlainConvUNet, build_plain_unet_spec
from nextou_tpu_torch.models.residual_unet import (
    ResidualEncoderUNet,
    build_residual_encoder_unet_spec,
)
from nextou_tpu_torch.models.spec import (
    DecoderStageSpec,
    GNNBlockSpec,
    ModelSpec,
    StageSpec,
    build_model_spec,
    knn_schedule,
)
