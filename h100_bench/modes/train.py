"""Mode ``train``: the trainer's loop body, as ``run_training`` runs it.

Set-up builds the configuration's trainer on the card (``initialize()``,
device augmentation and recomputation as the trainer decides them) with the
configuration's ``trainer_seed`` (the trainer's default), so that every run
samples and augments alike and does the same work; it writes the traffic's
labelled cases, made from the run's seed, as a preprocessed dataset under
``TMPDIR``, loads the benchmark's weights, made from the run's seed, into
the network, and drives the same
train step object through its first steps with batches from its own
``get_dataloaders()`` train loader: the first ``check_steps`` of them are
the ones the reference follows. The window then runs ``next(train_it)`` and
``trainer.train_step(trainer.state, batch)`` until its seconds are up,
adding the losses on the device, read once at the end.

The comparison (after the window, the program's state freed): the
reference network, loss and SGD, float32 with TF32 off, from the same seeded
weights, on the batches worked out again from the same files and generator
seeds (``reference/data.py``), for ``check_steps`` steps. Numbers: the
largest relative gap of a step's loss; the worst leaf's gap between the
program's and the reference's norms of the first gradient as the optimizer
received it (the momentum after step 1 less the weight decay's share); the
worst leaf's gap of the norms of the parameters' change after the checked
steps; each gap over the larger of the reference leaf's norm and the median
leaf's. Leaves whose reference gradient is under a thousandth of the median
leaf's (biases under a BatchNorm, zero but for rounding) are left out of both.
"""

from __future__ import annotations

import dataclasses
import json
import math
import tempfile
import time

import numpy as np
import torch

from h100_bench import bench, flops, roofline, synthetic
from h100_bench.reference import data as ref_data
from h100_bench.reference.losses import deep_supervised
from h100_bench.reference.network import NexToU as RefNet
from h100_bench.reference.sgd import sgd_step
from h100_bench.reference.spec import spec_from_config
from h100_bench.weights import load_into, make_weights, param_shapes

SMALL_LEAF = 1e-3  # of the median leaf's gradient norm


def leaf_gaps(prog: dict, ref: dict, keep: set) -> dict:
    """Each kept leaf's gap of norms, over the larger of the reference
    leaf's norm and the median kept leaf's."""
    med = float(np.median([ref[n] for n in keep]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in keep}


class Cell:
    def __init__(self, run: bench.Run):
        self.run = run
        self.traffic = run.traffic
        self.checked = int(run.cell["check_steps"])

    # --- set-up ---------------------------------------------------------------------

    def setup(self):
        run, cfg, dev = self.run, self.run.config, self.run.device
        t = time.perf_counter()
        from nextou_tpu_torch.kernels.build import build_kernels
        from nextou_tpu_torch.models import presets
        from nextou_tpu_torch.train import get_trainer_class
        t = run.part("imports", t)
        if dev.type == "cuda":
            build_kernels()
        t = run.part("kernels", t)
        self.tmp = tempfile.TemporaryDirectory(prefix="h100_bench_")
        self.folder = self.tmp.name
        cases = synthetic.make_cases(self.traffic, cfg, run.seed, dev)
        self.train_ids = synthetic.write_dataset(self.folder, cases, cfg, run.seed)
        del cases
        t = run.part("data", t)
        trainer = get_trainer_class(cfg["trainer"])(
            {"dataset_name": "Dataset999_Bench", "plans_name": "nnUNetPlans",
             "configurations": {cfg["configuration"]: cfg["plans"]}},
            cfg["configuration"], 0, cfg["dataset_json"], preprocessed_folder=self.folder,
            output_folder=self.folder + "/out", device=dev, seed=cfg["trainer_seed"],
            device_da=cfg["device_da"])
        trainer.initialize()
        if trainer.loader_threads != cfg["loader_threads"]:
            raise AssertionError(f"the trainer's loader has {trainer.loader_threads} threads")
        if cfg["preset"] and trainer.model_spec != getattr(presets, cfg["preset"])(
                num_classes=cfg["num_classes"]):
            raise AssertionError(f"the trainer's network is not {cfg['preset']}()")
        self.spec = spec_from_config(cfg, True)
        if dataclasses.asdict(self.spec) != dataclasses.asdict(trainer.model_spec):
            raise AssertionError("the reference's network differs from the trainer's")
        weights = make_weights(param_shapes(self.spec), run.seed, dev, cfg["branch_scale"])
        load_into(trainer.network, weights)
        del weights
        self.trainer = trainer
        self.batch = trainer.batch_size
        run.stats["flops_per_unit"] = flops.train_step_flops(self.spec, self.batch)
        run.stats["knn_bound_ms_per_unit"] = roofline.knn_bound_ms(self.spec, self.batch, True)
        run.stats["forwards_per_unit"] = 1
        t = run.part("weights", t)
        self.loader, _ = trainer.get_dataloaders()
        self.it = iter(self.loader)
        self._checked_steps()
        self.wait, self.steps, self.loss_sum = 0.0, 0, torch.zeros((), device=dev)
        for _ in range(int(run.cell["warmup_steps"])):
            self.unit()
        run.sync()
        run.part("warmup", t)

    def _checked_steps(self):
        """The program's first steps through the window's own call and feed,
        and what they leave: losses, first-gradient and change norms per leaf."""
        tr = self.trainer
        names, params = zip(*tr.network.named_parameters())
        p0 = [p.detach().clone() for p in params]
        losses = []
        for step in range(self.checked):
            tr.state, metrics = tr.train_step(tr.state, next(self.it))
            losses.append(metrics["loss"].float())
            if step == 0:
                decay = tr.optimizer.weight_decay
                self.grad_norms = {n: torch.linalg.vector_norm(m - decay * q).item()
                                   for n, m, q in zip(names, tr.state.momentum, p0)}
        self.change_norms = {n: torch.linalg.vector_norm(p.detach() - q).item()
                             for n, p, q in zip(names, params, p0)}
        self.losses = [v.item() for v in losses]
        bench.log("program losses", self.losses)

    # --- the window -----------------------------------------------------------------

    def unit(self):
        t = time.perf_counter()
        batch = next(self.it)
        self.wait += time.perf_counter() - t
        self.trainer.state, metrics = self.trainer.train_step(self.trainer.state, batch)
        self.loss_sum = self.loss_sum + metrics["loss"].float()
        self.steps += 1

    def window(self, seconds: float) -> dict:
        run = self.run
        self.wait, self.steps = 0.0, 0
        self.loss_sum = torch.zeros((), device=run.device)
        run.sync()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.unit()
        mean_loss = self.loss_sum.item() / self.steps  # waits for the last step
        elapsed = time.perf_counter() - t0
        run.attempted = self.steps
        if not math.isfinite(mean_loss):
            run.failed = self.steps
        run.stats.update(window_s=elapsed, units=self.steps,
                         loader_wait_share=100.0 * self.wait / elapsed)
        bench.log(f"window: {self.steps} steps in {elapsed:.3f} s, {elapsed / self.steps:.4f} "
                  f"s per step, mean loss {mean_loss:.5f}, loader wait {self.wait:.3f} s")
        return {"train_patches_per_s": self.steps * self.batch / elapsed}

    def after_trace(self):
        """``augment_ms``: device augmentation of batches the loader gave, by
        CUDA events, after the window."""
        from nextou_tpu_torch.data.device_augment import device_augment_batch

        if not self.trainer.device_da:
            return
        aug = self.trainer._augment_config()
        times = []
        for _ in range(3):
            b = next(self.it)
            data = torch.as_tensor(b["data"]).to(self.run.device)
            seg = torch.as_tensor(b["seg"]).to(self.run.device)
            times.append(cuda_ms(lambda: device_augment_batch(data, seg, b["plans"], aug)))
        self.run.stats["augment_ms"] = float(np.median(times))

    def release(self):
        self.loader.stop()
        del self.trainer, self.loader, self.it
        torch.cuda.empty_cache() if self.run.device.type == "cuda" else None

    # --- the comparison -------------------------------------------------------------

    def reference_readings(self, precision: str = "f32") -> tuple:
        """``(losses, first-gradient norms, change norms)`` per leaf of the
        reference over the checked steps."""
        run, cfg, dev = self.run, self.run.config, self.run.device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        net = RefNet(self.spec, precision).to(dev)
        load_into(net, make_weights(param_shapes(self.spec), run.seed, dev, cfg["branch_scale"]))
        names, params = zip(*net.named_parameters())
        params = list(params)
        p0 = [p.detach().clone() for p in params]
        momentum = [torch.zeros_like(p) for p in params]
        aug = ref_data.aug_for_patch(cfg["plans"]["patch_size"])
        cases = synthetic.read_cases(self.folder, self.train_ids)
        batches = ref_data.batches(cases, aug, self.batch, cfg["oversample_foreground"],
                                   cfg["trainer_seed"], cfg["loader_threads"], self.checked)
        losses, grad_norms = [], None
        for step, (data, seg) in enumerate(batches):
            outs = net(torch.from_numpy(data).to(dev), training=True)
            loss = deep_supervised(outs, torch.from_numpy(seg).to(dev), cfg["loss"])
            # the lowest-resolution head has weight 0: no gradient, zeros for the update
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, torch.autograd.grad(loss, params, allow_unused=True))]
            del outs
            clipped = sgd_step(params, grads, momentum, step)
            losses.append(loss.item())
            if step == 0:
                grad_norms = {n: torch.linalg.vector_norm(g).item()
                              for n, g in zip(names, clipped)}
        change = {n: torch.linalg.vector_norm(p.detach() - q).item()
                  for n, p, q in zip(names, params, p0)}
        return losses, grad_norms, change

    @staticmethod
    def gaps(prog: tuple, ref: tuple) -> dict:
        """The compared numbers of ``prog``'s readings against ``ref``'s, and
        beside them (``worst_*``, ``*_median``, ``loss_gaps``) where they come from."""
        losses, grads, change = ref
        med = float(np.median(list(grads.values())))
        keep = {n for n, g in grads.items() if g >= SMALL_LEAF * med}
        out = {"loss_gaps": [abs(p - r) / abs(r) for p, r in zip(prog[0], losses)]}
        out["loss_gap"] = max(out["loss_gaps"])
        for name, p, r in (("grad", prog[1], grads), ("update", prog[2], change)):
            g = leaf_gaps(p, r, keep)
            out[f"{name}_gap"] = max(g.values())
            out[f"{name}_gap_median"] = float(np.median(list(g.values())))
            out[f"worst_{name}"] = [(n, g[n], p[n], r[n])
                                    for n in sorted(g, key=g.get, reverse=True)[:4]]
        return out

    def check(self) -> list:
        t = time.perf_counter()
        self.ref = self.reference_readings()
        gaps = self.gaps((self.losses, self.grad_norms, self.change_norms), self.ref)
        self.last_gaps = gaps
        lim = self.run.config["limits"]["train"]
        bench.log(f"reference losses {self.ref[0]}; reference {time.perf_counter() - t:.1f} s; "
                  f"{json.dumps({k: v for k, v in gaps.items() if k not in lim})}")
        return [(name, gaps[name], limit) for name, limit in lim.items()]

    def close(self):
        self.tmp.cleanup()


def cuda_ms(fn, iters: int = 3, warmup: int = 1) -> float:
    """Milliseconds per call by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters
