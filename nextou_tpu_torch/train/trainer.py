"""The base trainer: nnU-Net's training protocol, counterpart of
``nextou_tpu/train/trainer.py``.

``Trainer(plans, configuration, fold, dataset_json, ...)``, 1000 epochs x 250
iterations, SGD (momentum 0.99, Nesterov) with PolyLR from 1e-2, gradient
clipping at 12, deep supervision with 1/2^i weights (the last zeroed), 33%
foreground oversampling, EMA (0.9) pseudo-Dice model selection,
``checkpoint_latest.pth`` every 50 epochs, ``checkpoint_best.pth`` and
``checkpoint_final.pth``, then the final validation (sliding-window
prediction of the validation cases and ``validation/summary.json``).

The architecture is NexToU whatever the plans' ``UNet_class_name`` says, as
in the reference trainer (``nnUNetTrainer_NexToU.py:31``); ``nnUNetTrainer``
(``trainers.py``) builds the class the plans name instead. A cascade
configuration (one with a ``previous_stage``) reads the previous stage's
predictions from ``<preprocessed>/predicted_next_stage/<previous stage>/``
(``predict_next_stage``) and takes them as one-hot foreground channels after
the image's, perturbed in training (``data/loader.py``).

It runs on one ``device``, the card unless the caller asks for the CPU,
computing in bf16 there (f32 on the CPU) with f32 parameters. The host
samples patches in ``loader_threads`` threads while the card trains; losses
and the pseudo-Dice statistics stay on the device and are read once per
epoch. With ``device_da`` (``"auto"``: on for a CUDA device, off on the CPU
and for a cascade, the JAX trainer's rule on the port's accelerator) the
threads only draw each sample's augmentation plan and the train step
augments on the device (``data/device_augment.py``), to the host path's
batch; otherwise the threads augment on the host (``data/augment.py``).

Data parallel (``parallel/``): launched by ``torch.distributed.run``, each
rank trains on its own device with ``local_share(batch_size)`` of the
global batch, its loaders seeded ``seed + 9973 * rank``; rank 0's
parameters are broadcast after the initialization, and the BatchNorm
statistics, the losses and the gradients are the global batch's, so a step
is the one-process step at the global batch (the JAX trainer's sharded
step). The pseudo-Dice statistics are summed over the ranks once per epoch;
every rank then makes the same EMA and checkpoint choices. Only rank 0
prints, writes the log, the plot, the checkpoints and the final validation,
which the other ranks wait for.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from nextou_tpu_torch.data import (
    AugmentConfig,
    PatchDataLoader,
    PatchSampler,
    PreprocessedDataset,
    initial_patch_size,
    make_splits,
)
from nextou_tpu_torch.losses import CompoundLossSpec, deep_supervision_weights
from nextou_tpu_torch.models import NexToU
from nextou_tpu_torch.models.plans_network import plans_network_spec
from nextou_tpu_torch.nn.conv_blocks import check_conv_kernel
from nextou_tpu_torch.parallel import (
    all_reduce,
    barrier,
    broadcast_module,
    is_lead,
    local_share,
    rank,
    world_size,
)
from nextou_tpu_torch.plans import PlansManager
from nextou_tpu_torch.predict import compute_dtype
from nextou_tpu_torch.train.checkpoint import load_checkpoint, restore_pretrained, save_checkpoint
from nextou_tpu_torch.train.optimizer import make_optimizer, poly_lr
from nextou_tpu_torch.train.registry import register_trainer
from nextou_tpu_torch.train.state import create_train_state
from nextou_tpu_torch.train.train_step import make_eval_step, make_train_step, pseudo_dice

# remat="auto" on a card. The estimate is nnU-Net's feature-map count (conv
# outputs of one forward) x batch x 2 bytes x 6, as the JAX trainer computes
# it. On an NVIDIA H100 80GB HBM3 the flagship's train step at batch 2 in
# bf16, which that estimate puts at 18.38 GiB, peaked at 16.41 GiB without
# recomputation and at 4.98 GiB with every stage recomputed
# (torch.cuda.max_memory_allocated, chip_smoke.py). So the peak is predicted
# as the estimate times these shares, and the trainer keeps every activation
# when that fits AUTO_REMAT_BUDGET of the card's memory, else recomputes
# every stage. 'big' (the large stages only) has no measured peak on the
# card and is never chosen automatically.
PEAK_PER_ESTIMATE = {False: 16.41 / 18.38, True: 4.98 / 18.38}
AUTO_REMAT_BUDGET = 0.8


def auto_remat(estimate_bytes: float, device: torch.device) -> tuple[bool, str]:
    """``(remat, reason)`` for the activation estimate on ``device``: no
    recomputation where its predicted peak fits the budget of the card's
    memory, every stage recomputed where it does not. The CPU has no budget:
    nothing is recomputed."""
    if device.type != "cuda":
        return False, "no device memory budget on the CPU"
    total = torch.cuda.get_device_properties(device).total_memory
    budget = AUTO_REMAT_BUDGET * total
    remat = estimate_bytes * PEAK_PER_ESTIMATE[False] > budget
    peak = estimate_bytes * PEAK_PER_ESTIMATE[remat]
    return remat, (f"predicted peak {peak / 2**30:.2f} GiB against a budget of "
                   f"{budget / 2**30:.2f} GiB ({AUTO_REMAT_BUDGET:.0%} of {total / 2**30:.2f} GiB)")


@register_trainer
class NexToUTrainer:
    """Base trainer (registry name alias: ``nnUNetTrainer_NexToU``)."""

    num_epochs: int = 1000
    num_iterations_per_epoch: int = 250
    num_val_iterations_per_epoch: int = 50
    initial_lr: float = 1e-2
    weight_decay: float = 3e-5
    grad_clip_norm: float = 12.0
    oversample_foreground_percent: float = 0.333
    ema_decay: float = 0.9
    checkpoint_every: int = 50

    def __init__(
        self,
        plans: dict | str,
        configuration: str,
        fold: int | str,
        dataset_json: dict,
        preprocessed_folder: str | None = None,
        output_folder: str = "./nextou_output",
        *,
        device: str | torch.device = "cuda",
        remat: bool | str = "auto",
        device_da: bool | str = "auto",
        seed: int = 12345,
        num_epochs: int | None = None,
        num_iterations_per_epoch: int | None = None,
        batch_size: int | None = None,
        loader_threads: int = 2,
        conv_kernel: str = "0",
    ):
        self.plans_manager = PlansManager(plans)
        self.configuration_name = configuration
        self.configuration_manager = self.plans_manager.get_configuration(configuration)
        self.fold = fold
        self.dataset_json = dataset_json
        self.label_manager = self.plans_manager.get_label_manager(dataset_json)
        self.preprocessed_folder = preprocessed_folder
        self.output_folder = output_folder
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype(self.device)
        self.remat = remat
        self.device_da = device_da
        self.seed = seed
        # producer threads of the host loader (nnUNet_n_proc_DA's role); 1
        # makes the batch order a function of the seed alone
        self.loader_threads = loader_threads
        # the convs the hand-written conv kernel takes (nn/conv_blocks.py)
        self.conv_kernel = check_conv_kernel(conv_kernel)
        if num_epochs is not None:
            self.num_epochs = num_epochs
        if num_iterations_per_epoch is not None:
            self.num_iterations_per_epoch = num_iterations_per_epoch
        self.batch_size = batch_size or self.configuration_manager.batch_size

        self.enable_deep_supervision = True
        # TTA mirror axes; the NoMirroring trainers set this to None
        dim = self.configuration_manager.spatial_dims
        self.inference_allowed_mirroring_axes: tuple[int, ...] | None = tuple(range(dim))

        self.current_epoch = 0
        self._best_ema: float | None = None
        self.ema_pseudo_dice: float | None = None
        self.log_history: list[dict] = []
        self._initialized = False

    # ------------------------------------------------------------------ #
    # configuration hooks (overridden by the registry trainer subclasses)
    # ------------------------------------------------------------------ #

    def configure_mirroring(self) -> tuple[int, ...]:
        """Train-time mirror axes (all axes by default, nnU-Net style)."""
        return tuple(range(self.configuration_manager.spatial_dims))

    def configure_rotation_dummyDA_mirroring_and_initial_patch_size(self):
        """nnU-Net's DA-configuration hook (the reference's NoMirroring
        trainers override it, ``nnUNetTrainer_NexToU_NoMirroring.py:5``):
        rotation ranges depend on the patch aspect ratio, and strongly
        anisotropic 3D patches get in-plane-only ('dummy 2D') spatial DA.

        Returns (rotation_rad per axis, do_dummy_2d, mirror_axes).
        """
        patch = self.configuration_manager.patch_size
        if len(patch) == 2:
            do_dummy = False
            rot = (np.pi / 12.0,) if max(patch) / min(patch) > 1.5 else (np.pi,)
        else:
            do_dummy = max(patch) / patch[0] > 3  # ANISO_THRESHOLD
            rot = (np.pi,) * 3 if do_dummy else (np.pi / 6.0,) * 3
        return rot, do_dummy, self.configure_mirroring()

    def _resolve_device_da(self) -> None:
        """``nextou_tpu/train/trainer.py::_resolve_device_da`` with the card
        as the accelerator: ``"auto"`` is on for a CUDA device and off on
        the CPU; a cascade keeps host augmentation (its one-hot noise needs
        connected components on the host)."""
        if self.device_da == "auto":
            self.device_da = self.device.type == "cuda" and not self._cascade()
        if self.device_da and self._cascade():
            self.print_to_log_file(
                "device_da disabled: cascade one-hot noise needs host-side connected components")
            self.device_da = False

    def _augment_config(self) -> AugmentConfig:
        rot, do_dummy, mirror = self.configure_rotation_dummyDA_mirroring_and_initial_patch_size()
        return AugmentConfig(
            rotation_rad=tuple(rot), dummy_2d=do_dummy, mirror_axes=mirror,
            final_patch_size=tuple(self.configuration_manager.patch_size),
        )

    def _loss_spec(self) -> CompoundLossSpec:
        """DC + CE (the base nnUNetTrainer loss); the TI/BTI trainers
        override it. Region-based datasets switch to sigmoid region-Dice +
        BCE."""
        lm = self.label_manager
        return CompoundLossSpec(
            weight_ce=1.0, weight_dice=1.0, weight_ti=0.0,
            batch_dice=self.configuration_manager.batch_dice, smooth=1e-5, do_bg=False,
            ignore_label=lm.ignore_label,
            regions=tuple(lm.foreground_regions) if lm.has_regions else None,
        )

    def build_network_spec(self):
        return plans_network_spec(
            self.configuration_manager, self._num_input_channels(),
            self.label_manager.num_segmentation_heads, self.enable_deep_supervision,
            nextou=True)

    def _num_input_channels(self) -> int:
        ch = self.dataset_json.get("channel_names") or self.dataset_json.get("modality", {"0": "X"})
        # a cascade stage takes the previous stage's prediction as one-hot
        # foreground channels (nnU-Net's determine_num_input_channels)
        prev = len(self.label_manager.foreground_labels) if self._cascade() else 0
        return max(1, len(ch)) + prev

    def _cascade(self) -> bool:
        return self.configuration_manager.previous_stage_name is not None

    def _prev_stage_folder(self) -> str | None:
        prev = self.configuration_manager.previous_stage_name
        if prev is None:
            return None
        folder = os.path.join(self.preprocessed_folder, "predicted_next_stage", prev)
        if not os.path.isdir(folder):
            raise FileNotFoundError(
                f"cascade configuration '{self.configuration_name}' needs previous-stage "
                f"predictions at {folder} — run `python -m nextou_tpu_torch.predict_next_stage` "
                f"on the '{prev}' model first")
        return folder

    # ------------------------------------------------------------------ #
    # initialization
    # ------------------------------------------------------------------ #

    def initialize(self):
        if self._initialized:
            return self
        # this rank's share of the global batch (raises on an uneven split)
        self.local_batch_size = local_share(self.batch_size)
        self._resolve_device_da()
        self.model_spec = self.build_network_spec()
        if self.remat == "auto":
            probe = NexToU(self.model_spec, device="meta")
            estimate = probe.compute_conv_feature_map_size() * self.local_batch_size * 2 * 6
            del probe
            self.remat, reason = auto_remat(estimate, self.device)
            self.print_to_log_file(
                f"auto remat: {self.remat!r} (activation estimate {estimate / 2**30:.2f} GiB; "
                f"{reason})")
        self.network = NexToU(self.model_spec, dtype=self.compute_dtype, remat=self.remat,
                              conv_kernel=self.conv_kernel, device=self.device)
        self.loss_spec = self._loss_spec()
        n_ds = len(self.model_spec.decoder)
        self.ds_weights = deep_supervision_weights(n_ds) if self.enable_deep_supervision else None
        schedule = poly_lr(self.initial_lr, self.num_epochs, 0.9,
                           steps_per_epoch=self.num_iterations_per_epoch)
        self.optimizer = make_optimizer(schedule, weight_decay=self.weight_decay,
                                        clip_norm=self.grad_clip_norm)
        self.state = create_train_state(self.network, self.optimizer, self.seed)
        # the JAX trainer's replicate: rank 0's parameters and statistics on
        # every rank (each also initialized them from the same seed)
        broadcast_module(self.network)
        self.train_step = make_train_step(
            self.network, self.optimizer, self.loss_spec, self.ds_weights,
            augment=self._augment_config() if self.device_da else None)
        self.eval_step = make_eval_step(self.network, self.loss_spec, self.ds_weights)
        # plans + dataset.json beside the checkpoints, as the substrate does
        if is_lead():
            os.makedirs(self.output_folder, exist_ok=True)
            with open(os.path.join(self.output_folder, "plans.json"), "w") as f:
                json.dump(self.plans_manager.plans, f, indent=2, default=float)
            with open(os.path.join(self.output_folder, "dataset.json"), "w") as f:
                json.dump(self.dataset_json, f, indent=2)
        self._initialized = True
        return self

    # ------------------------------------------------------------------ #
    # data
    # ------------------------------------------------------------------ #

    def get_split(self):
        # one subfolder per configuration (keyed by data_identifier, like
        # nnU-Net) where it exists; flat folders work too
        data_dir = self.preprocessed_folder
        ident = self.configuration_manager.data_identifier
        if ident and os.path.isdir(os.path.join(data_dir, ident)):
            data_dir = os.path.join(data_dir, ident)
        dataset = PreprocessedDataset(data_dir, prev_stage_folder=self._prev_stage_folder())
        if self.fold == "all":
            return dataset, dataset
        splits_path = os.path.join(self.preprocessed_folder, "splits_final.json")
        if os.path.exists(splits_path):
            with open(splits_path) as f:
                splits = json.load(f)
        else:
            splits = make_splits(dataset.case_ids)
            if is_lead():
                # whole or absent for a rank that reads it meanwhile
                with open(splits_path + ".tmp", "w") as f:
                    json.dump(splits, f)
                os.replace(splits_path + ".tmp", splits_path)
        fold = splits[int(self.fold)]
        return dataset.subset(fold["train"]), dataset.subset(fold["val"])

    def get_dataloaders(self):
        train_ds, val_ds = self.get_split()
        patch = tuple(self.configuration_manager.patch_size)
        self._resolve_device_da()
        aug = self._augment_config()
        # both DA paths sample the larger initial patch (nnU-Net's exact
        # rotate-then-crop, data/augment.py); validation samples the final size
        sampler_patch = initial_patch_size(patch, aug.rotation_rad, aug.dummy_2d, aug.scale_range)
        self.print_to_log_file(f"{'device' if self.device_da else 'host'} DA: initial patch "
                               f"size {sampler_patch} -> {patch}")
        # each rank loads its share of the global batch from its own seeds
        # (the JAX trainer's seed + 9973 * process index)
        batch, seed = local_share(self.batch_size), self.seed + 9973 * rank()
        train_sampler = PatchSampler(train_ds, sampler_patch, batch,
                                     self.oversample_foreground_percent, seed=seed)
        val_sampler = PatchSampler(val_ds, patch, batch,
                                   self.oversample_foreground_percent, seed=seed + 1)
        onehot = tuple(self.label_manager.foreground_labels) if self._cascade() else None
        train_loader = PatchDataLoader(train_sampler, augment=aug, seed=seed,
                                       num_threads=self.loader_threads, onehot_labels=onehot,
                                       cascade_noise=self._cascade(),
                                       device_augment=self.device_da)
        val_loader = PatchDataLoader(val_sampler, augment=None, seed=seed + 7,
                                     num_threads=self.loader_threads, onehot_labels=onehot)
        return train_loader, val_loader

    # ------------------------------------------------------------------ #
    # training loop
    # ------------------------------------------------------------------ #

    def print_to_log_file(self, *msgs):
        if not is_lead():
            return  # data parallel: only rank 0 prints and logs
        line = " ".join(str(m) for m in msgs)
        print(line, flush=True)
        os.makedirs(self.output_folder, exist_ok=True)
        with open(os.path.join(self.output_folder, "training_log.txt"), "a") as f:
            f.write(time.strftime("%Y-%m-%d %H:%M:%S ") + line + "\n")

    def profile_steps(self, n_steps: int = 5, trace_dir: str | None = None) -> str:
        """A ``torch.profiler`` trace of ``n_steps`` train steps, written as
        ``trace_dir/trace.json`` (Chrome trace format), the counterpart of
        the JAX trainer's ``jax.profiler`` trace. The first step runs
        outside the trace."""
        from torch.profiler import ProfilerActivity, profile

        self.initialize()
        train_loader, _ = self.get_dataloaders()
        trace_dir = trace_dir or os.path.join(self.output_folder, "trace")
        os.makedirs(trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with train_loader:
            it = iter(train_loader)
            _, metrics = self.train_step(self.state, next(it))
            metrics["loss"].item()  # the first step ends before the trace starts
            with profile(activities=activities) as prof:
                for _ in range(n_steps):
                    self.state, metrics = self.train_step(self.state, next(it))
                metrics["loss"].item()
        path = os.path.join(trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        self.print_to_log_file(f"profiler trace of {n_steps} steps written to {path}")
        return path

    def run_training(self):
        self.initialize()
        train_loader, val_loader = self.get_dataloaders()
        self.print_to_log_file(
            f"Training {type(self).__name__} on '{self.configuration_name}' fold {self.fold} "
            f"on {self.device} ({str(self.compute_dtype)[6:]}): {self.num_epochs} epochs x "
            f"{self.num_iterations_per_epoch} iters, batch {self.batch_size}, "
            f"{self.loader_threads} loader threads of {os.cpu_count()} cores")
        if torch.distributed.is_initialized():
            self.print_to_log_file(
                f"data parallel: world size {world_size()}, backend "
                f"{torch.distributed.get_backend()}, local batch "
                f"{self.local_batch_size}")
        zero = lambda: torch.zeros((), dtype=torch.float32, device=self.device)  # noqa: E731
        with train_loader, val_loader:
            train_it, val_it = iter(train_loader), iter(val_loader)
            for epoch in range(self.current_epoch, self.num_epochs):
                self.current_epoch = epoch
                t0 = time.perf_counter()
                # the losses add up on the device: nothing is read per step
                loss_sum, first_loss, wait = zero(), None, 0.0
                reduces = all_reduce.calls
                for _ in range(self.num_iterations_per_epoch):
                    t = time.perf_counter()
                    batch = next(train_it)
                    wait += time.perf_counter() - t
                    self.state, metrics = self.train_step(self.state, batch)
                    loss_sum += metrics["loss"].float()
                    if first_loss is None:
                        first_loss = metrics["loss"].float()
                # each rank's loss is the global batch's: the same on every rank
                train_loss = loss_sum.item() / self.num_iterations_per_epoch
                train_s = time.perf_counter() - t0
                reduces = all_reduce.calls - reduces

                val_sum, stats = zero(), None
                for _ in range(self.num_val_iterations_per_epoch):
                    out = self.eval_step(self.state, next(val_it))
                    val_sum += out["loss"].float()
                    new = torch.stack([out["tp"], out["fp"], out["fn"]])
                    stats = new if stats is None else stats + new
                n_val = max(1, self.num_val_iterations_per_epoch)
                val_loss = val_sum.item() / n_val
                if stats is not None and world_size() > 1:
                    all_reduce(stats)  # the ranks' sum, once per epoch
                if stats is None:
                    dice_per_class = np.zeros(0)
                else:
                    tp, fp, fn = stats.cpu()
                    dice_per_class = pseudo_dice(tp, fp, fn).double().numpy()
                mean_dice = float(np.nanmean(dice_per_class)) if dice_per_class.size else 0.0
                if np.isnan(mean_dice):
                    # every class absent from prediction and ground truth
                    # this epoch: 0 rather than a NaN that poisons the EMA
                    # (NaN > best is always False: no checkpoint_best again)
                    mean_dice = 0.0
                if self.ema_pseudo_dice is None:
                    self.ema_pseudo_dice = mean_dice
                else:
                    self.ema_pseudo_dice = (self.ema_decay * self.ema_pseudo_dice
                                            + (1 - self.ema_decay) * mean_dice)
                epoch_time = time.perf_counter() - t0
                self.log_history.append({
                    "epoch": epoch,
                    "train_loss": train_loss,
                    "first_step_loss": None if first_loss is None else first_loss.item(),
                    "val_loss": val_loss,
                    "pseudo_dice": [float(d) for d in dice_per_class],
                    "ema_pseudo_dice": self.ema_pseudo_dice,
                    "epoch_time_s": epoch_time,
                    "train_time_s": train_s,
                    "loader_wait_s": wait,
                    "train_all_reduces": reduces,
                })
                self.print_to_log_file(
                    f"epoch {epoch}: train_loss {train_loss:.4f} val_loss {val_loss:.4f} "
                    f"pseudo_dice {np.round(dice_per_class, 4).tolist()} "
                    f"ema {self.ema_pseudo_dice:.4f} ({epoch_time:.1f}s; train {train_s:.2f}s, "
                    f"of which waiting for the loader {wait:.2f}s)")
                if self._best_ema is None or self.ema_pseudo_dice > self._best_ema:
                    self._best_ema = self.ema_pseudo_dice
                    self.save_checkpoint("checkpoint_best.pth")
                if (epoch + 1) % self.checkpoint_every == 0:
                    self.save_checkpoint("checkpoint_latest.pth")
                self.plot_progress()
        self.save_checkpoint("checkpoint_final.pth")
        return self.state

    def plot_progress(self):
        """Write ``progress.png`` (the substrate's per-epoch training curve:
        losses, EMA pseudo-Dice, epoch time). Best effort: without
        matplotlib nothing is plotted. Only rank 0 plots."""
        if not self.log_history or not is_lead():
            return
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:  # plotting is best-effort observability
            return
        h = self.log_history
        ep = [e["epoch"] for e in h]
        fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(8, 7), sharex=True)
        ax1.plot(ep, [e["train_loss"] for e in h], label="train loss")
        ax1.plot(ep, [e["val_loss"] for e in h], label="val loss")
        ax1b = ax1.twinx()
        ax1b.plot(ep, [e["ema_pseudo_dice"] for e in h], color="tab:green", label="EMA pseudo-Dice")
        ax1.set_ylabel("loss")
        ax1b.set_ylabel("EMA pseudo-Dice")
        ax1.legend(loc="upper left")
        ax1b.legend(loc="upper right")
        ax2.plot(ep, [e["epoch_time_s"] for e in h])
        ax2.set_ylabel("epoch time (s)")
        ax2.set_xlabel("epoch")
        fig.tight_layout()
        fig.savefig(os.path.join(self.output_folder, "progress.png"), dpi=100)
        plt.close(fig)

    # ------------------------------------------------------------------ #
    # final validation (nnU-Net's perform_actual_validation + summary.json)
    # ------------------------------------------------------------------ #

    def load_pretrained_weights(self, path: str) -> None:
        """Seed this (fresh) training with another run's network weights,
        ``nnUNetv2_train -pretrained_weights``: momentum and generator stay
        fresh, and entries whose shape differs keep their initialization
        (``train/checkpoint.py::restore_pretrained``)."""
        self.initialize()
        self.state, report = restore_pretrained(self.state, path)
        self.print_to_log_file(
            f"pretrained weights from {path}: {len(report['loaded'])} tensors loaded, "
            f"{len(report['skipped_shape'])} shape-skipped, {len(report['missing'])} missing")
        for name in report["skipped_shape"]:
            self.print_to_log_file(f"  shape mismatch, kept fresh: {name}")

    def build_predictor(self, tile_batch: int = 2):
        """``data (*sp, C) -> probs (*sp, heads)`` through the predictor that
        ``nextou_tpu_torch.predict`` serves with: the trained network without
        deep supervision, on the trainer's device and in its compute dtype,
        with the trainer's TTA mirror axes."""
        from nextou_tpu_torch.predict import build_predictor

        spec = dataclasses.replace(self.model_spec, deep_supervision=False)
        model = NexToU(spec, dtype=self.compute_dtype, conv_kernel=self.conv_kernel,
                       device=self.device)
        model.load_state_dict(self.network.state_dict())
        regions = self.label_manager.has_regions
        return build_predictor(
            model.eval(), self.inference_allowed_mirroring_axes, tile_batch=tile_batch,
            activation="sigmoid" if regions else "softmax",
        )

    def perform_actual_validation(self, tile_batch: int = 2, save_probabilities: bool = False) -> dict:
        """Sliding-window prediction of every validation case and per-class
        metrics written to ``<output>/validation/summary.json``. Each case's
        segmentation is stored as ``validation/{case}.npz`` ('seg', int16),
        with ``save_probabilities`` (the ``--npz`` flag) also its
        probabilities ('probabilities', float16, (*sp, C)). A cascade stage
        takes each case's previous-stage prediction as its ``-prev`` channels.
        Under data parallel rank 0 validates while the other ranks wait at a
        barrier, and they return None."""
        self.initialize()
        if not is_lead():
            barrier()
            return None
        try:
            return self._validate(tile_batch, save_probabilities)
        finally:
            barrier()

    def _validate(self, tile_batch: int, save_probabilities: bool) -> dict:
        from nextou_tpu_torch.infer.evaluate import evaluate_cases
        from nextou_tpu_torch.predict import onehot_channels

        _, val_ds = self.get_split()
        val_dir = os.path.join(self.output_folder, "validation")
        os.makedirs(val_dir, exist_ok=True)
        predictor = self.build_predictor(tile_batch)
        lm = self.label_manager
        cases = []
        for cid in val_ds.case_ids:
            case = val_ds.load(cid)
            data = np.moveaxis(case.data, 0, -1)
            if case.seg_prev is not None:  # a cascade stage: the -prev channels
                data = np.concatenate([data, onehot_channels(case.seg_prev, lm.foreground_labels)],
                                      axis=-1)
            probs = predictor(data)
            seg = lm.convert_probabilities_to_segmentation(probs)
            payload = {"seg": np.asarray(seg, np.int16)}
            if save_probabilities:
                payload["probabilities"] = np.asarray(probs, np.float16)
            np.savez_compressed(os.path.join(val_dir, f"{cid}.npz"), **payload)
            cases.append((seg, case.seg, cid))
        # region datasets are evaluated per region mask, like nnU-Net
        labels = lm.foreground_regions if lm.has_regions else lm.all_labels
        summary = evaluate_cases(cases, labels, os.path.join(val_dir, "summary.json"))
        self.print_to_log_file("validation foreground mean Dice:",
                               summary["foreground_mean"]["Dice"])
        return summary

    # ------------------------------------------------------------------ #
    # checkpointing
    # ------------------------------------------------------------------ #

    def save_checkpoint(self, name: str):
        if not is_lead():
            return  # data parallel: the state is the same on every rank
        extra = {
            "current_epoch": self.current_epoch,
            "_best_ema": self._best_ema,
            "ema_pseudo_dice": self.ema_pseudo_dice,
            "logging": self.log_history,
            "trainer_name": type(self).__name__,
            "configuration": self.configuration_name,
            "fold": self.fold,
            "inference_allowed_mirroring_axes": self.inference_allowed_mirroring_axes,
        }
        save_checkpoint(os.path.join(self.output_folder, name), self.state, extra)

    def load_checkpoint(self, path: str) -> dict:
        """Resume from ``path``, this port's ``.pth`` or a ``nextou_tpu``
        ``.ckpt``: training goes on from the epoch after the one saved."""
        self.initialize()
        self.state, extra = load_checkpoint(path, self.state)
        self.current_epoch = extra.get("current_epoch", 0) + 1
        self._best_ema = extra.get("_best_ema")
        self.ema_pseudo_dice = extra.get("ema_pseudo_dice")
        self.log_history = extra.get("logging", [])
        return extra
