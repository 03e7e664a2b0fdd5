"""nnU-Net-plans-compatible configuration loading.

Carried over unchanged from ``nextou_tpu/plans/loader.py`` (json only): the
port imports nothing of the JAX package, so it keeps its own copy.

Reads the same ``nnUNetPlans.json`` / ``dataset.json`` files upstream NexToU
consumes, including single-parent ``inherits_from`` merging
(upstream ``nnUNetPlans.json:426-439``) — so an existing
nnU-Net user can point this framework at their preprocessed dataset folder
unchanged. Mirrors the public surface of nnU-Net's ``PlansManager`` /
``ConfigurationManager`` / ``LabelManager`` that the reference trainer touches
(``nnUNetTrainer_NexToU.py:13-15``).
"""

from __future__ import annotations

import json
import os
from functools import cached_property
from typing import Any


class ConfigurationManager:
    """One resolved configuration dict with convenience accessors."""

    def __init__(self, config: dict[str, Any]):
        self.configuration = config

    @property
    def patch_size(self) -> list[int]:
        return list(self.configuration["patch_size"])

    @property
    def batch_size(self) -> int:
        return int(self.configuration["batch_size"])

    @property
    def spacing(self) -> list[float]:
        return list(self.configuration["spacing"])

    @property
    def normalization_schemes(self) -> list[str]:
        return list(self.configuration.get("normalization_schemes", []))

    @property
    def use_mask_for_norm(self) -> list[bool]:
        return list(self.configuration.get("use_mask_for_norm", []))

    @property
    def conv_kernel_sizes(self) -> list[list[int]]:
        return [list(k) for k in self.configuration["conv_kernel_sizes"]]

    @property
    def pool_op_kernel_sizes(self) -> list[list[int]]:
        return [list(k) for k in self.configuration["pool_op_kernel_sizes"]]

    @property
    def n_conv_per_stage_encoder(self) -> list[int]:
        return list(self.configuration["n_conv_per_stage_encoder"])

    @property
    def n_conv_per_stage_decoder(self) -> list[int]:
        return list(self.configuration["n_conv_per_stage_decoder"])

    @property
    def UNet_base_num_features(self) -> int:
        return int(self.configuration["UNet_base_num_features"])

    @property
    def unet_max_num_features(self) -> int:
        return int(self.configuration["unet_max_num_features"])

    @property
    def UNet_class_name(self) -> str:
        return self.configuration.get("UNet_class_name", "PlainConvUNet")

    @property
    def batch_dice(self) -> bool:
        return bool(self.configuration["batch_dice"])

    @property
    def num_stages(self) -> int:
        return len(self.conv_kernel_sizes)

    @property
    def spatial_dims(self) -> int:
        return len(self.patch_size)

    @property
    def data_identifier(self) -> str:
        return self.configuration.get("data_identifier", "")

    @property
    def previous_stage_name(self) -> str | None:
        return self.configuration.get("previous_stage")

    @property
    def next_stage_names(self) -> list[str] | None:
        n = self.configuration.get("next_stage")
        if n is None:
            return None
        return n if isinstance(n, list) else [n]

    def features_per_stage(self) -> list[int]:
        """``min(base * 2^i, max)`` — exactly how the reference trainer builds
        the channel schedule (``nnUNetTrainer_NexToU.py:78-79``)."""
        return [
            min(self.UNet_base_num_features * 2**i, self.unet_max_num_features)
            for i in range(self.num_stages)
        ]

    # --- resampling kwargs (the plans hard-code resample_data_or_seg_to_shape
    # with these; upstream nnUNetPlans.json:132-152). Missing keys fall
    # back to the substrate defaults so hand-written minimal plans behave like
    # nnU-Net's shipped ones.

    def _resampling_kwargs(self, key: str, default: dict) -> dict:
        kw = dict(self.configuration.get(key, default))
        kw.pop("is_seg", None)  # implied by which entry point is used
        return kw

    @property
    def resampling_fn_data_kwargs(self) -> dict:
        return self._resampling_kwargs(
            "resampling_fn_data_kwargs",
            {"order": 3, "order_z": 0, "force_separate_z": None},
        )

    @property
    def resampling_fn_seg_kwargs(self) -> dict:
        return self._resampling_kwargs(
            "resampling_fn_seg_kwargs",
            {"order": 0, "order_z": 0, "force_separate_z": None},
        )

    @property
    def resampling_fn_probabilities_kwargs(self) -> dict:
        return self._resampling_kwargs(
            "resampling_fn_probabilities_kwargs",
            {"order": 1, "order_z": 0, "force_separate_z": None},
        )


class LabelManager:
    """Label bookkeeping from dataset.json (nnU-Net's LabelManager surface).

    Supports plain integer labels and region-based labels (list values +
    ``regions_class_order``): in region mode the network gets one sigmoid
    head per region (no background head) and predictions are converted back
    to labels by painting the regions in order.
    """

    def __init__(self, dataset_json: dict[str, Any]):
        self.dataset_json = dataset_json
        labels = dataset_json["labels"]
        self.label_dict = {str(k): v for k, v in labels.items()}

    @cached_property
    def all_labels(self) -> list[int]:
        vals = []
        for k, v in self.label_dict.items():
            if k == "ignore":
                continue
            if isinstance(v, (list, tuple)):
                vals.extend(int(x) for x in v)
            else:
                vals.append(int(v))
        return sorted(set(vals))

    @cached_property
    def has_regions(self) -> bool:
        return any(
            isinstance(v, (list, tuple)) and len(v) > 1
            for k, v in self.label_dict.items()
            if k != "ignore"
        )

    @cached_property
    def foreground_regions(self) -> list[tuple[int, ...]]:
        """Region label-sets in dataset.json order, background excluded."""
        out = []
        for k, v in self.label_dict.items():
            if k in ("background", "ignore"):
                continue
            if isinstance(v, (list, tuple)):
                out.append(tuple(int(x) for x in v))
            else:
                out.append((int(v),))
        return out

    @property
    def regions_class_order(self) -> list[int]:
        order = self.dataset_json.get("regions_class_order")
        if order is not None:
            return [int(x) for x in order]
        if self.has_regions:
            # nnU-Net requires it with list-valued labels; a silent
            # foreground_labels fallback can mismatch the region-channel
            # count and paint wrong label values
            raise ValueError(
                "dataset.json defines region-based labels but no "
                "regions_class_order"
            )
        return self.foreground_labels

    @property
    def num_segmentation_heads(self) -> int:
        if self.has_regions:
            return len(self.foreground_regions)
        return len(self.all_labels)

    @property
    def foreground_labels(self) -> list[int]:
        return [l for l in self.all_labels if l != 0]

    @property
    def ignore_label(self) -> int | None:
        v = self.label_dict.get("ignore")
        return int(v) if v is not None else None

    def convert_probabilities_to_segmentation(self, probs) -> Any:
        """(\\*sp, H) probabilities -> (\\*sp) int labels.

        Region mode: threshold each sigmoid region channel at 0.5 and paint
        the corresponding ``regions_class_order`` label, later regions
        overwriting earlier ones (nnU-Net semantics). Label mode: argmax.
        """
        import numpy as np

        probs = np.asarray(probs)
        if not self.has_regions:
            return np.argmax(probs, axis=-1).astype(np.int16)
        seg = np.zeros(probs.shape[:-1], np.int16)
        for i, label in enumerate(self.regions_class_order):
            seg[probs[..., i] > 0.5] = label
        return seg


class PlansManager:
    """Loads a plans dict/file and resolves configurations with
    ``inherits_from`` chains."""

    def __init__(self, plans: dict[str, Any] | str):
        if isinstance(plans, str):
            with open(plans) as f:
                plans = json.load(f)
        self.plans = plans

    @property
    def dataset_name(self) -> str:
        return self.plans.get("dataset_name", "")

    @property
    def plans_name(self) -> str:
        return self.plans.get("plans_name", "nnUNetPlans")

    @property
    def available_configurations(self) -> list[str]:
        return list(self.plans["configurations"].keys())

    def _resolve(self, name: str, _seen: tuple[str, ...] = ()) -> dict[str, Any]:
        if name in _seen:
            raise ValueError(f"circular inherits_from chain: {_seen + (name,)}")
        configs = self.plans["configurations"]
        if name not in configs:
            raise KeyError(
                f"configuration '{name}' not in plans "
                f"(available: {sorted(configs)})"
            )
        cfg = dict(configs[name])
        parent = cfg.pop("inherits_from", None)
        if parent is not None:
            base = self._resolve(parent, _seen + (name,))
            merged = dict(base)
            merged.update(cfg)
            cfg = merged
        return cfg

    def get_configuration(self, name: str) -> ConfigurationManager:
        return ConfigurationManager(self._resolve(name))

    def get_label_manager(self, dataset_json: dict[str, Any]) -> LabelManager:
        return LabelManager(dataset_json)

    @property
    def transpose_forward(self) -> list[int]:
        return list(self.plans.get("transpose_forward", []))

    @property
    def transpose_backward(self) -> list[int]:
        return list(self.plans.get("transpose_backward", []))


def load_dataset_json(folder_or_file: str) -> dict[str, Any]:
    path = folder_or_file
    if os.path.isdir(path):
        path = os.path.join(path, "dataset.json")
    with open(path) as f:
        return json.load(f)
