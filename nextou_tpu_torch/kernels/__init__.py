from nextou_tpu_torch.kernels.knn import (
    build_knn_max,
    knn_max_cuda,
    knn_max_neighbors,
    knn_max_neighbors_reference,
)
