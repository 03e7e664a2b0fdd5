from nextou_tpu_torch.kernels.knn import (
    KnnMaxTrain,
    build_kernels,
    knn_indices_cuda,
    knn_indices_reference,
    knn_max_bwd_cuda,
    knn_max_bwd_reference,
    knn_max_cuda,
    knn_max_idx_cuda,
    knn_max_idx_reference,
    knn_max_neighbors,
    knn_max_neighbors_reference,
)
