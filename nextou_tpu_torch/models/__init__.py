from nextou_tpu_torch.models.nextou import NexToU
from nextou_tpu_torch.models.spec import (
    DecoderStageSpec,
    GNNBlockSpec,
    ModelSpec,
    StageSpec,
    build_model_spec,
    knn_schedule,
)
