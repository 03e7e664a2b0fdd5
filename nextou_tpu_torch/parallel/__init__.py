from nextou_tpu_torch.parallel.distributed import (
    all_reduce,
    all_reduce_sum,
    average_gradients,
    barrier,
    initialize_distributed,
    is_lead,
    launched,
    local_share,
    mean_over_ranks,
    rank,
    rank_device,
    sum_over_ranks,
    world_size,
)
from nextou_tpu_torch.parallel.mesh import broadcast_module, local_devices, replicate_to
