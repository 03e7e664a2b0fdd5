"""Preprocessed cases on disk."""

from nextou_tpu_torch.data.dataset import PreprocessedDataset, make_splits, save_case
