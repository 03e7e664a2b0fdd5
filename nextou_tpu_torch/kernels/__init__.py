from nextou_tpu_torch.kernels.build import build_kernels
from nextou_tpu_torch.kernels.conv import (
    Conv3dKernel,
    conv3d,
    conv3d_cuda,
    conv3d_reference,
    conv_kernel_wins,
)
from nextou_tpu_torch.kernels.knn import (
    KnnMaxTrain,
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
