from nextou_tpu_torch.core.graph import (
    batched_index_select,
    dense_knn,
    dense_knn_reference,
    dilated_knn_graph,
    knn_sq_dist,
    l2_normalize,
    xy_pairwise_sq_dist,
)
from nextou_tpu_torch.core.pos_embed import relative_pos_bias
from nextou_tpu_torch.core.window import window_partition, window_reverse
