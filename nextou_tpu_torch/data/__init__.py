"""Preprocessed cases on disk, patch sampling, host augmentation and the
prefetching loader."""

from nextou_tpu_torch.data.augment import AugmentConfig, augment_batch, initial_patch_size
from nextou_tpu_torch.data.dataset import PreprocessedDataset, make_splits, save_case
from nextou_tpu_torch.data.loader import PatchDataLoader
from nextou_tpu_torch.data.sampler import PatchSampler, extract_patch
