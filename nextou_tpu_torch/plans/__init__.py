"""Plans and dataset.json loading (``nnUNetPlans.json`` compatible)."""

from nextou_tpu_torch.plans.loader import (
    ConfigurationManager,
    LabelManager,
    PlansManager,
    load_dataset_json,
)
