from nextou_tpu_torch.losses.ce import cross_entropy_elementwise, cross_entropy_loss
from nextou_tpu_torch.losses.compound import (
    CompoundLossSpec,
    dc_ce_ti_loss,
    region_targets,
)
from nextou_tpu_torch.losses.deep_supervision import (
    deep_supervised_loss,
    deep_supervision_weights,
    downsample_target,
)
from nextou_tpu_torch.losses.dice import region_soft_dice_loss, soft_dice_loss
from nextou_tpu_torch.losses.ti import TILossSpec, critical_voxels_map, ti_loss
