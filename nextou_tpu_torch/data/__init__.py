"""Raw images (NIfTI), their preprocessing and resampling; preprocessed
cases on disk, patch sampling, host augmentation, its on-device
counterpart and the prefetching loader."""

from nextou_tpu_torch.data.augment import AugmentConfig, augment_batch, initial_patch_size
from nextou_tpu_torch.data.dataset import PreprocessedDataset, make_splits, save_case
from nextou_tpu_torch.data.device_augment import (
    AugmentPlan,
    affine_resample,
    device_augment_batch,
    draw_augment_plan,
    gaussian_blur,
    lowres_axis_operator,
)
from nextou_tpu_torch.data.io import read_image, read_nifti, write_nifti
from nextou_tpu_torch.data.loader import PatchDataLoader
from nextou_tpu_torch.data.preprocessing import (
    crop_to_nonzero,
    normalize,
    preprocess_case,
    resample_to_shape,
    shape_for_spacing,
    zscore_normalize,
)
from nextou_tpu_torch.data.resampling import (
    resample_data_or_seg,
    resample_data_or_seg_to_shape,
    resize_segmentation,
)
from nextou_tpu_torch.data.sampler import PatchSampler, extract_patch
