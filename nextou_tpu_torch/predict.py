"""CLI + API: predict preprocessed or raw cases with trained checkpoints.

Counterpart of ``nextou_tpu/predict.py``: the plans configuration gives the
network, built as the trainer named builds it (NexToU under the seven NexToU
trainers, the plans' ``UNet_class_name`` under ``nnUNetTrainer``), the
trainer name gives the TTA mirror axes, and each case goes through the
Gaussian sliding window, its accumulators on the device while they fit
``ACC_BUDGET_BYTES`` and in host memory above it (every forward runs on the
device either way). ``-f``
averages several folds' probabilities. A preprocessed case's ``{case}.npz``
gets ``seg`` (and with ``--save-probabilities`` its ``probabilities``,
float16); with ``--raw`` a folder of raw images (``{case}_0000.nii.gz``) goes
through crop, normalization and resampling to the plans' spacing and back
(``infer/raw.py``), and ``{case}.nii.gz`` is written at the input's geometry.

    python -m nextou_tpu_torch.predict MODEL_FOLDER DATASET_FOLDER CONFIGURATION \\
        -o OUTPUT [--raw] [-f 0 1 ...] [-tr nnUNetTrainer_NexToU]
        [-chk checkpoint_final.pth] [-prev PREV_FOLDER] [--save-probabilities]
        [-pp postprocessing.json] [--conv-kernel {0,1,s1,s2}] [--all-devices] [--device cpu]

With ``--raw`` the plans (``plans.json``) and ``dataset.json`` are read from
the model folder, where the trainer writes them. The checkpoint is a torch
file holding ``{'network_weights': state_dict}`` under upstream's parameter
names, the layout of upstream nnU-Net checkpoints; their DDP/compile prefixes
and alias keys are stripped
(:func:`~nextou_tpu_torch.compat.weights.extract_network_weights`), or a
``nextou_tpu`` ``.ckpt``, read without jax, flax or msgpack
(:mod:`~nextou_tpu_torch.compat.flax_ckpt`). A cascade configuration takes
the previous stage's segmentations with ``-prev`` (``{case}.npz`` with
``seg``, on this configuration's grid or resampled onto it by order 0) as
one-hot foreground channels. Computes in bf16 on a CUDA device, which is
where it runs unless ``--device cpu`` asks for the CPU (f32): without a card
and without that option it fails. ``--all-devices`` holds a replica of the
network on every visible card and splits each forward's tiles over them
(the tile batch rounded up to a multiple of their count); with one card it
is the one-card path.
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Callable, Iterator, Sequence

import numpy as np
import torch

from nextou_tpu_torch.compat.flax_ckpt import read_ckpt
from nextou_tpu_torch.compat.weights import extract_network_weights, variables_to_state_dict
from nextou_tpu_torch.data.dataset import PreprocessedDataset
from nextou_tpu_torch.data.preprocessing import resample_to_shape
from nextou_tpu_torch.infer.raw import predict_raw_folder
from nextou_tpu_torch.infer.sliding_window import (
    make_device_sliding_predictor,
    make_tile_predictor,
    replicated_forward,
    sliding_window_predict,
)
from nextou_tpu_torch.models.nextou import NexToU
from nextou_tpu_torch.models.plans_network import plans_network_spec
from nextou_tpu_torch.models.spec import ModelSpec
from nextou_tpu_torch.nn.conv_blocks import CONV_KERNEL_MODES
from nextou_tpu_torch.parallel.mesh import local_devices, replicate_to
from nextou_tpu_torch.paths import resolve_preprocessed, resolve_raw
from nextou_tpu_torch.postprocess import apply_postprocessing
from nextou_tpu_torch.plans.loader import PlansManager, load_dataset_json

# the seven public NexToU trainer names and nnUNetTrainer (the network the
# plans name); the _NoMirroring ones predict without mirror TTA (upstream
# nnUNetTrainer_NexToU_NoMirroring.py:8-9)
TRAINERS = (
    "nnUNetTrainer",
    "nnUNetTrainer_NexToU",
    "nnUNetTrainer_NexToU_NoMirroring",
    "nnUNetTrainer_NexToU_TI",
    "nnUNetTrainer_NexToU_TI_NoMirroring",
    "nnUNetTrainer_NexToU_BTI_Synapse",
    "nnUNetTrainer_NexToU_BTI_RAVIR",
    "nnUNetTrainer_NexToU_BTI_ICA_NoMirroring",
)
# device-resident accumulation budget: f32 accumulators + the volume; a
# volume above it is accumulated in host memory
ACC_BUDGET_BYTES = 4 << 30
# the accumulation path a predictor took on its last call (``predict.path``)
DEVICE_ACCUMULATION = "device accumulation"
HOST_ACCUMULATION = "host accumulation"


def mirror_axes_for(trainer: str, spatial_dims: int) -> tuple[int, ...] | None:
    if trainer not in TRAINERS:
        raise ValueError(f"unknown trainer {trainer!r}; known: {TRAINERS}")
    return None if trainer.endswith("_NoMirroring") else tuple(range(spatial_dims))


def build_spec(plans: PlansManager, configuration: str, dataset_json: dict,
               trainer: str = "nnUNetTrainer_NexToU") -> ModelSpec:
    """The inference spec (deep supervision off) of the network ``trainer``
    builds for a plans configuration (``train/trainer.py::build_network_spec``):
    NexToU, or under ``nnUNetTrainer`` the plans' ``UNet_class_name``. A
    cascade stage's inputs include the previous stage's one-hot foreground
    channels."""
    if trainer not in TRAINERS:
        raise ValueError(f"unknown trainer {trainer!r}; known: {TRAINERS}")
    cm = plans.get_configuration(configuration)
    labels = plans.get_label_manager(dataset_json)
    channels = dataset_json.get("channel_names") or dataset_json.get("modality", {"0": "X"})
    prev = len(labels.foreground_labels) if cm.previous_stage_name is not None else 0
    return plans_network_spec(
        cm, max(1, len(channels)) + prev, labels.num_segmentation_heads, False,
        nextou=trainer != "nnUNetTrainer")


def compute_dtype(device: torch.device) -> torch.dtype:
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def load_model(spec: ModelSpec, checkpoint: str, device: torch.device,
               conv_kernel: str = "0") -> NexToU:
    """Build the network on ``device`` and load ``checkpoint``'s weights, a
    torch checkpoint or, by its ``.ckpt`` suffix, a ``nextou_tpu`` one;
    ``conv_kernel`` as :class:`~nextou_tpu_torch.models.nextou.NexToU` takes it."""
    model = NexToU(spec, dtype=compute_dtype(device), conv_kernel=conv_kernel, device=device)
    if checkpoint.endswith(".ckpt"):
        model.load_state_dict(variables_to_state_dict(read_ckpt(checkpoint).variables, spec))
    else:
        ckpt = torch.load(checkpoint, map_location=device, weights_only=True)
        model.load_state_dict(extract_network_weights(ckpt))
    return model.eval()


def load_dataset(dataset_folder: str, configuration: str, trainer: str = "nnUNetTrainer_NexToU"
                 ) -> tuple[PlansManager, dict, ModelSpec]:
    """``(plans, dataset_json, inference spec)`` of a preprocessed dataset folder."""
    plans = PlansManager(os.path.join(dataset_folder, "nnUNetPlans.json"))
    dataset_json = load_dataset_json(dataset_folder)
    return plans, dataset_json, build_spec(plans, configuration, dataset_json, trainer)


def onehot_channels(seg: np.ndarray, labels: Sequence[int]) -> np.ndarray:
    """A previous stage's segmentation ``(*sp)`` as the cascade's one-hot
    foreground channels ``(*sp, len(labels))`` f32."""
    return np.stack([seg == label for label in labels], axis=-1).astype(np.float32)


def load_prev_stage(folder: str, cid: str, shape: Sequence[int]) -> np.ndarray:
    """Case ``cid``'s previous-stage segmentation from ``folder``, on a grid of
    ``shape``: resampled by order 0 where it lies on another one (``predict``
    writes on the previous stage's grid, ``predict_next_stage`` on the next
    one's)."""
    with np.load(os.path.join(folder, f"{cid}.npz")) as z:
        prev = z["seg"]
    if prev.ndim == len(shape) + 1:
        prev = np.squeeze(prev, 0)
    if tuple(prev.shape) != tuple(shape):
        prev = resample_to_shape(prev.astype(np.float32), shape, order=0).astype(np.int32)
    return prev


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
    devices: Sequence[torch.device] | None = None,
) -> Callable[[np.ndarray], np.ndarray]:
    """``data (*sp, C_in) -> probs (*sp, num_classes) f32``, or with
    ``output='seg'`` (label mode) the argmax ``(*sp)`` as uint8 (int16 above
    255 classes), every forward on the model's device. With several
    ``devices`` (the model's own first) a replica of the model lies on each,
    the tile batch is rounded up to a multiple of their count and each
    forward's tiles are split over them
    (:func:`~nextou_tpu_torch.infer.sliding_window.replicated_forward`); the
    accumulators stay on the first.

    The accumulators stay on the device while ``vox * (num_classes + 1 +
    C_in) * 4`` bytes fit ``ACC_BUDGET_BYTES``, and live in host memory above
    it (``nextou_tpu/predict.py::build_predictor``); ``predict.path`` names
    the path its last call took. A 2d network over a 3d case predicts slice
    by slice along the leading axis."""
    spec = model.spec
    device = next(model.parameters()).device
    patch, ncls = tuple(spec.patch_size), spec.num_classes
    apply = model
    if devices is not None and len(devices) > 1:
        apply = replicated_forward(replicate_to(model, devices))
        tile_batch = -(-tile_batch // len(devices)) * len(devices)
    tile_pred = make_tile_predictor(apply, mirror_axes, activation)
    device_pred = make_device_sliding_predictor(
        apply, mirror_axes, patch, ncls, device=device,
        tile_batch=tile_batch, activation=activation, output=output,
        step_fraction=step_size,
    )
    seg_dtype = np.uint8 if ncls <= 255 else np.int16

    def predict(data: np.ndarray) -> np.ndarray:
        if data.ndim - 1 == len(patch) + 1:
            # a 2d configuration on a volumetric case: slice by slice along
            # the leading axis (nnU-Net's 2d inference over 3d data)
            return np.stack([predict(data[z]) for z in range(data.shape[0])])
        acc_bytes = int(np.prod(data.shape[:-1])) * (ncls + 1 + data.shape[-1]) * 4
        if acc_bytes <= ACC_BUDGET_BYTES:
            predict.path = DEVICE_ACCUMULATION
            return device_pred(data).cpu().numpy()
        predict.path = HOST_ACCUMULATION
        probs = sliding_window_predict(
            tile_pred, data, patch, ncls, device=device, step_fraction=step_size,
            tile_batch=tile_batch,
        )
        return np.argmax(probs, axis=-1).astype(seg_dtype) if output == "seg" else probs

    predict.path = None
    return predict


def build_fold_ensemble_predictor(
    models: Sequence[NexToU],
    mirror_axes: Sequence[int] | None,
    *,
    tile_batch: int = 2,
    output: str = "probs",
    step_size: float = 0.5,
    activation: str = "softmax",
    devices: Sequence[torch.device] | None = None,
) -> Callable[[np.ndarray], np.ndarray]:
    """Average the sliding-window probabilities of several folds' models,
    nnU-Net's ``-f 0 1 2 3 4`` cross-validation ensemble (softmax averaged
    over folds before the argmax). ``output='seg'`` applies to a single fold
    only: an ensemble needs the probabilities."""
    if len(models) > 1:
        output = "probs"
    predictors = [
        build_predictor(m, mirror_axes, tile_batch=tile_batch, output=output,
                        step_size=step_size, activation=activation, devices=devices)
        for m in models
    ]
    if len(predictors) == 1:
        return predictors[0]

    def predict(data: np.ndarray) -> np.ndarray:
        acc = None
        for p in predictors:
            probs = p(data)
            acc = probs if acc is None else acc + probs
        predict.path = predictors[0].path
        return acc / len(predictors)

    predict.path = None
    return predict


def _fold_model_folders(model_folder: str, folds) -> list[str]:
    """Per-fold checkpoint folders: ``..._fold_N`` siblings (the trainer's
    layout) or ``fold_N/`` subfolders (nnU-Net's layout)."""
    base = model_folder.rstrip("/")
    m = re.search(r"fold_(\d+|all)$", base)
    out = []
    for f in folds:
        if m is not None:
            out.append(base[: m.start()] + f"fold_{f}")
        elif os.path.isdir(os.path.join(base, f"fold_{f}")):
            out.append(os.path.join(base, f"fold_{f}"))
        else:
            raise SystemExit(
                f"cannot resolve fold {f}: {model_folder} neither ends in "
                "fold_N nor contains fold_N subfolders"
            )
    for p in out:
        if not os.path.isdir(p):
            raise SystemExit(f"fold folder does not exist: {p}")
    return out


def load_postprocessing(path: str) -> dict:
    """The operations of a ``postprocessing.json`` (``postprocess
    determine``), or of an ``inference_information.json`` that carries them
    under ``'postprocessing'``."""
    with open(path) as f:
        pp = json.load(f)
    pp = pp.get("postprocessing", pp)
    if "remove_all_but_largest_component" not in pp:
        raise SystemExit(f"{path} carries no postprocessing operations")
    return pp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("model_folder", help="folder holding the checkpoint")
    ap.add_argument("dataset_folder", help="preprocessed dataset folder "
                    "(nnUNetPlans.json, dataset.json, {case}.npz), or with --raw a folder "
                    "of raw images ({case}_{0000..}.nii.gz)")
    ap.add_argument("configuration")
    ap.add_argument("--raw", action="store_true",
                    help="raw images: preprocess, predict, resample back and write NIfTI "
                    "segmentations at the input's geometry (plans.json and dataset.json "
                    "are read from the model folder)")
    ap.add_argument("-tr", "--trainer", default="nnUNetTrainer_NexToU")
    ap.add_argument("-f", "--folds", nargs="*", default=None,
                    help="average these folds' probabilities; the model folder ends in "
                    "fold_N (siblings) or holds fold_N subfolders")
    ap.add_argument("-chk", default="checkpoint_final.pth",
                    help="checkpoint file in each model folder: a torch .pth or a nextou_tpu "
                    ".ckpt")
    ap.add_argument("-prev", "--prev-stage-predictions", default=None,
                    help="cascade: folder of the previous stage's {case}.npz segmentations "
                    "(from predict_next_stage or predict)")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--cases", nargs="*", default=None)
    ap.add_argument("--tile-batch", type=int, default=2)
    ap.add_argument("-step_size", "--step-size", type=float, default=0.5)
    ap.add_argument("--disable-tta", "--disable_tta", action="store_true")
    ap.add_argument("-pp", "--postprocessing", default=None,
                    help="apply the operations of a postprocessing.json (postprocess "
                    "determine) to every written segmentation")
    ap.add_argument("--save-probabilities", action="store_true",
                    help="also store the probabilities (float16) in the output npz, "
                    "for the ensemble CLI")
    ap.add_argument("--conv-kernel", choices=CONV_KERNEL_MODES, default="0",
                    help="hand the convs of the hand-written conv kernel's region to it: "
                    "all (1), the stride-1 ones (s1) or the strided ones (s2)")
    ap.add_argument("--all-devices", action="store_true",
                    help="split each forward's tiles over every visible card, one replica of "
                    "the network on each")
    ap.add_argument("--device", default="cuda",
                    help="the card by default; 'cpu' computes on the CPU in f32")
    args = ap.parse_args(argv)
    if args.raw and args.save_probabilities:
        raise SystemExit(
            "--save-probabilities is not supported with --raw (raw mode writes NIfTI "
            "segmentations at the original geometry; ensembling inputs need predictions "
            "on the preprocessed grid: predict the preprocessed folder instead)")
    postprocess = None
    if args.postprocessing is not None:
        pp = load_postprocessing(args.postprocessing)

        def postprocess(seg):
            return apply_postprocessing(seg, pp)

    device = torch.device(args.device)
    if args.raw:
        dataset_folder = resolve_raw(args.dataset_folder)
        plans = PlansManager(os.path.join(args.model_folder, "plans.json"))
        dataset_json = load_dataset_json(args.model_folder)
        spec = build_spec(plans, args.configuration, dataset_json, args.trainer)
    else:
        dataset_folder = resolve_preprocessed(args.dataset_folder)
        plans, dataset_json, spec = load_dataset(dataset_folder, args.configuration, args.trainer)
    labels = plans.get_label_manager(dataset_json)
    prev_folder = None
    if plans.get_configuration(args.configuration).previous_stage_name is not None:
        if args.prev_stage_predictions is None:
            raise SystemExit(f"configuration '{args.configuration}' is a cascade stage: pass "
                             "-prev with the previous stage's predictions")
        prev_folder = args.prev_stage_predictions
    mirror = mirror_axes_for(args.trainer, spec.spatial_dims)
    folders = _fold_model_folders(args.model_folder, args.folds) if args.folds else [
        args.model_folder]
    models = [load_model(spec, os.path.join(f, args.chk), device, args.conv_kernel)
              for f in folders]
    regions = labels.has_regions
    # label mode, one fold, no saved probabilities: only the seg leaves the device
    want_seg = not (args.raw or args.save_probabilities or regions or len(models) > 1)
    predictor = build_fold_ensemble_predictor(
        models, None if args.disable_tta else mirror,
        tile_batch=args.tile_batch, step_size=args.step_size,
        output="seg" if want_seg else "probs",
        activation="sigmoid" if regions else "softmax",
        devices=local_devices(device) if args.all_devices else None,
    )
    if args.raw:
        prev_seg_loader = None
        if prev_folder is not None:
            def prev_seg_loader(cid, shape):
                # channels first, on this case's preprocessed grid
                hot = onehot_channels(load_prev_stage(prev_folder, cid, shape),
                                      labels.foreground_labels)
                return np.moveaxis(hot, -1, 0)
        predict_raw_folder(
            predictor, dataset_folder, args.output, plans,
            plans.get_configuration(args.configuration), dataset_json,
            cases=args.cases, prev_seg_loader=prev_seg_loader, postprocess=postprocess,
        )
        return

    os.makedirs(args.output, exist_ok=True)
    with open(os.path.join(args.output, "dataset.json"), "w") as f:
        json.dump(dataset_json, f)  # label semantics for the ensemble and evaluation
    for cid, data in iter_cases(dataset_folder, plans, args.configuration, args.cases):
        if prev_folder is not None:
            prev = load_prev_stage(prev_folder, cid, data.shape[:-1])
            data = np.concatenate([data, onehot_channels(prev, labels.foreground_labels)], -1)
        out = predictor(data)
        seg = out if want_seg else labels.convert_probabilities_to_segmentation(out)
        if postprocess is not None:
            seg = postprocess(seg)
        payload = {"seg": seg}
        if args.save_probabilities:
            payload["probabilities"] = out.astype(np.float16)
        np.savez_compressed(os.path.join(args.output, f"{cid}.npz"), **payload)
        print(f"predicted {cid}: {seg.shape} ({predictor.path})")


if __name__ == "__main__":
    main()
