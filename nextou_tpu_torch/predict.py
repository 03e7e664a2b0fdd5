"""CLI + API: predict preprocessed cases with a NexToU checkpoint.

Counterpart of ``nextou_tpu/predict.py`` for preprocessed cases: the plans
configuration gives the network (built the way the trainers build it), the
trainer name gives the TTA mirror axes, and each case goes through the
device-resident Gaussian sliding window; ``{case}.npz`` gets ``seg``.

    python -m nextou_tpu_torch.predict MODEL_FOLDER DATASET_FOLDER CONFIGURATION \\
        -o OUTPUT [-tr nnUNetTrainer_NexToU] [-chk checkpoint_final.pth]
        [--conv-kernel {0,1,s1,s2}] [--device cpu]

The checkpoint is a torch file holding ``{'network_weights': state_dict}``
under upstream NexToU's parameter names, the layout of upstream nnU-Net
checkpoints; their DDP/compile prefixes and alias keys are stripped
(:func:`~nextou_tpu_torch.compat.weights.extract_network_weights`). Computes
in bf16 on a CUDA device, which is where it runs unless ``--device cpu`` asks
for the CPU (f32): without a card and without that option it fails.

Not ported yet: ``--raw`` NIfTI input, fold ensembles, cascades,
postprocessing, ``--save-probabilities``, and loading a ``nextou_tpu``
(flax msgpack) checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from nextou_tpu_torch.compat.weights import extract_network_weights
from nextou_tpu_torch.data.dataset import PreprocessedDataset
from nextou_tpu_torch.infer.sliding_window import make_device_sliding_predictor
from nextou_tpu_torch.models.nextou import NexToU
from nextou_tpu_torch.models.spec import ModelSpec, build_model_spec
from nextou_tpu_torch.nn.conv_blocks import CONV_KERNEL_MODES
from nextou_tpu_torch.plans.loader import PlansManager, load_dataset_json

# the seven public NexToU trainer names; the _NoMirroring ones predict
# without mirror TTA (upstream nnUNetTrainer_NexToU_NoMirroring.py:8-9)
TRAINERS = (
    "nnUNetTrainer_NexToU",
    "nnUNetTrainer_NexToU_NoMirroring",
    "nnUNetTrainer_NexToU_TI",
    "nnUNetTrainer_NexToU_TI_NoMirroring",
    "nnUNetTrainer_NexToU_BTI_Synapse",
    "nnUNetTrainer_NexToU_BTI_RAVIR",
    "nnUNetTrainer_NexToU_BTI_ICA_NoMirroring",
)
# device-resident accumulation budget: f32 accumulators + the volume
ACC_BUDGET_BYTES = 4 << 30


def mirror_axes_for(trainer: str, spatial_dims: int) -> tuple[int, ...] | None:
    if trainer not in TRAINERS:
        raise ValueError(f"unknown trainer {trainer!r}; known: {TRAINERS}")
    return None if trainer.endswith("_NoMirroring") else tuple(range(spatial_dims))


def build_spec(plans: PlansManager, configuration: str, dataset_json: dict) -> ModelSpec:
    """The inference NexToU spec (deep supervision off) of a plans
    configuration, built like ``nextou_tpu/train/trainer.py::build_network_spec``."""
    cm = plans.get_configuration(configuration)
    if cm.previous_stage_name is not None:
        raise NotImplementedError("cascade configurations are not ported yet")
    channels = dataset_json.get("channel_names") or dataset_json.get("modality", {"0": "X"})
    return build_model_spec(
        in_channels=max(1, len(channels)),
        patch_size=cm.patch_size,
        n_stages=cm.num_stages,
        features_per_stage=cm.features_per_stage(),
        kernel_sizes=cm.conv_kernel_sizes,
        strides=cm.pool_op_kernel_sizes,
        n_conv_per_stage=cm.n_conv_per_stage_encoder,
        n_conv_per_stage_decoder=cm.n_conv_per_stage_decoder,
        num_classes=plans.get_label_manager(dataset_json).num_segmentation_heads,
        deep_supervision=False,
    )


def compute_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def load_model(spec: ModelSpec, checkpoint: str, device: torch.device,
               conv_kernel: str = "0") -> NexToU:
    """Build the network on ``device`` and load ``checkpoint``'s weights;
    ``conv_kernel`` as :class:`~nextou_tpu_torch.models.nextou.NexToU` takes it."""
    model = NexToU(spec, dtype=compute_dtype(device), conv_kernel=conv_kernel, device=device)
    ckpt = torch.load(checkpoint, map_location=device, weights_only=True)
    model.load_state_dict(extract_network_weights(ckpt))
    return model.eval()


def load_dataset(dataset_folder: str, configuration: str) -> tuple[PlansManager, dict, ModelSpec]:
    """``(plans, dataset_json, inference spec)`` of a preprocessed dataset folder."""
    plans = PlansManager(os.path.join(dataset_folder, "nnUNetPlans.json"))
    dataset_json = load_dataset_json(dataset_folder)
    return plans, dataset_json, build_spec(plans, configuration, dataset_json)


def iter_cases(
    dataset_folder: str, plans: PlansManager, configuration: str, cases=None
) -> Iterator[tuple[str, np.ndarray]]:
    """``(case_id, data (*sp, C_in) f32)`` for each preprocessed case, read
    from the configuration's data-identifier subfolder where it exists."""
    data_dir = dataset_folder
    ident = plans.get_configuration(configuration).data_identifier
    if ident and os.path.isdir(os.path.join(data_dir, ident)):
        data_dir = os.path.join(data_dir, ident)
    ds = PreprocessedDataset(data_dir, cases)
    for cid in ds.case_ids:
        yield cid, np.moveaxis(ds.load(cid).data, 0, -1)


def build_predictor(
    model: NexToU,
    mirror_axes: Sequence[int] | None,
    *,
    tile_batch: int = 2,
    output: str = "probs",
    step_size: float = 0.5,
    activation: str = "softmax",
) -> Callable[[np.ndarray], np.ndarray]:
    """``data (*sp, C_in) -> probs (*sp, num_classes) f32``, or with
    ``output='seg'`` the argmax ``(*sp)`` uint8, computed on the model's
    device. Raises for volumes whose accumulators exceed the device budget."""
    spec = model.spec
    device = next(model.parameters()).device
    device_pred = make_device_sliding_predictor(
        model, mirror_axes, spec.patch_size, spec.num_classes, device=device,
        tile_batch=tile_batch, activation=activation, output=output,
        step_fraction=step_size,
    )

    def predict(data: np.ndarray) -> np.ndarray:
        acc_bytes = int(np.prod(data.shape[:-1])) * (spec.num_classes + 1 + data.shape[-1]) * 4
        if acc_bytes > ACC_BUDGET_BYTES:
            raise NotImplementedError(
                f"volume {data.shape} needs {acc_bytes} B of device accumulators "
                f"(> {ACC_BUDGET_BYTES}); the host-accumulation fallback is not ported yet"
            )
        return device_pred(data).cpu().numpy()

    return predict


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model_folder", help="folder holding the checkpoint")
    ap.add_argument("dataset_folder", help="preprocessed dataset folder "
                    "(nnUNetPlans.json, dataset.json, {case}.npz)")
    ap.add_argument("configuration")
    ap.add_argument("-tr", "--trainer", default="nnUNetTrainer_NexToU")
    ap.add_argument("-chk", default="checkpoint_final.pth")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--cases", nargs="*", default=None)
    ap.add_argument("--tile-batch", type=int, default=2)
    ap.add_argument("-step_size", "--step-size", type=float, default=0.5)
    ap.add_argument("--disable-tta", "--disable_tta", action="store_true")
    ap.add_argument("--conv-kernel", choices=CONV_KERNEL_MODES, default="0",
                    help="hand the convs of the hand-written conv kernel's region to it: "
                    "all (1), the stride-1 ones (s1) or the strided ones (s2)")
    ap.add_argument("--device", default="cuda",
                    help="the card by default; 'cpu' computes on the CPU in f32")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    plans, dataset_json, spec = load_dataset(args.dataset_folder, args.configuration)
    labels = plans.get_label_manager(dataset_json)
    mirror = mirror_axes_for(args.trainer, spec.spatial_dims)
    model = load_model(spec, os.path.join(args.model_folder, args.chk), device,
                       args.conv_kernel)
    regions = labels.has_regions
    predictor = build_predictor(
        model, None if args.disable_tta else mirror,
        tile_batch=args.tile_batch, step_size=args.step_size,
        output="probs" if regions else "seg",
        activation="sigmoid" if regions else "softmax",
    )

    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "dataset.json"), "w") as f:
        json.dump(dataset_json, f)  # label semantics for evaluation
    for cid, data in iter_cases(args.dataset_folder, plans, args.configuration, args.cases):
        if data.ndim - 1 != spec.spatial_dims:
            raise NotImplementedError("2d configurations over 3d cases are not ported yet")
        out = predictor(data)
        seg = labels.convert_probabilities_to_segmentation(out) if regions else out
        np.savez_compressed(os.path.join(args.output, f"{cid}.npz"), seg=seg)
        print(f"predicted {cid}: {seg.shape}")


if __name__ == "__main__":
    main()
