"""Mode ``serve``: ``predict.build_predictor`` as ``predict.main`` serves a
folder, closed loop, one case at a time.

Set-up builds the configuration's network without deep supervision on the
card in bf16, loads the benchmark's seeded weights and BatchNorm statistics
(those of one float32 forward of the reference in training mode over the
first case's first tiles: a served network's statistics are its data's),
makes the traffic's pool of cases from the seed and serves the first case
twice (every shape of the cell). The window serves the pool's cases in turn,
host array in to host segmentation out, until its seconds are up; every case
started in it finishes. ``serve_mvox_per_s``: the input voxels of the cases
served over the time from the window's start to the end of the last; the
95th percentile of the cases' times goes to the per-layer ``latency_p95_s``.

The comparison (after the window, the program freed): a sample of the
served cases drawn from the seed, each predicted again by the reference's
plain sliding window (float32, TF32 off) with the same weights and
statistics. Each voxel's served label is judged by its gap: how far the
reference's probability of that label lies below the reference's largest
there. The numbers the configuration's limits name are taken from the gaps:
their mean, the share of voxels whose gap passes 0.01 or 0.05, the widest.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import time

import numpy as np
import torch

from h100_bench import bench, flops, roofline, synthetic
from h100_bench.reference import sliding
from h100_bench.reference.network import NexToU as RefNet
from h100_bench.reference.spec import spec_from_config
from h100_bench.weights import load_into, make_weights, param_shapes, running_stats


def tiles_per_case(shape, patch) -> int:
    return math.prod(len(s) for s in sliding.steps(shape, patch))


class Cell:
    def __init__(self, run: bench.Run):
        self.run = run
        self.traffic = run.traffic
        cfg = run.config
        self.patch = tuple(cfg["plans"]["patch_size"])
        self.mirror_axes = tuple(range(len(self.patch)))
        self.tile_batch = int(run.cell["tile_batch"])

    def reference_net(self, precision: str = "f32") -> RefNet:
        net = RefNet(self.spec, precision).to(self.run.device)
        load_into(net, make_weights(param_shapes(self.spec), self.run.seed, self.run.device,
                               self.run.config["branch_scale"]),
                  self.stats)
        return net

    def setup(self):
        run, cfg, dev = self.run, self.run.config, self.run.device
        t = time.perf_counter()
        from nextou_tpu_torch.kernels.build import build_kernels
        from nextou_tpu_torch.models import NexToU, presets
        from nextou_tpu_torch.plans import PlansManager
        from nextou_tpu_torch.predict import build_predictor, build_spec, compute_dtype
        t = run.part("imports", t)
        if dev.type == "cuda":
            build_kernels()
        t = run.part("kernels", t)
        cases = synthetic.make_cases(self.traffic, cfg, run.seed, dev)
        self.pool = [np.ascontiguousarray(d.float().cpu().numpy()[..., None]) for d, _ in cases]
        del cases
        t = run.part("data", t)
        self.spec = spec_from_config(cfg, False)
        plans = PlansManager({"configurations": {cfg["configuration"]: cfg["plans"]}})
        spec = build_spec(plans, cfg["configuration"], cfg["dataset_json"], cfg["trainer"])
        if cfg["preset"] and spec != getattr(presets, cfg["preset"])(
                num_classes=cfg["num_classes"], deep_supervision=False):
            raise AssertionError(f"the configuration's network is not {cfg['preset']}()")
        if dataclasses.asdict(spec) != dataclasses.asdict(self.spec):
            raise AssertionError("the reference's network differs from the program's")
        model = NexToU(spec, dtype=compute_dtype(dev), device=dev)
        # the reference's statistics over the first case's first tiles
        ref = RefNet(self.spec).to(dev)
        load_into(ref, make_weights(param_shapes(self.spec), run.seed, dev, cfg["branch_scale"]))
        first = torch.from_numpy(self.pool[0]).to(dev)
        corners = list(itertools.product(*sliding.steps(first.shape[:-1], self.patch)))[:2]
        tiles = torch.stack([first[tuple(slice(c, c + p) for c, p in zip(co, self.patch))]
                             for co in corners])
        with torch.no_grad():
            ref(tiles, training=True, calibrate=True)
        self.stats = running_stats(ref)
        del ref, tiles, first
        weights = make_weights(param_shapes(self.spec), run.seed, dev, cfg["branch_scale"])
        load_into(model, weights, self.stats)
        self.model = model.eval()
        per_case = tiles_per_case(self.pool[0].shape[:-1], self.patch)
        fwd = -(-per_case // self.tile_batch) * (2 ** len(self.mirror_axes)) // 2
        run.stats["forwards_per_unit"] = fwd
        run.stats["flops_per_unit"] = fwd * 2 * self.tile_batch * flops.forward_flops(self.spec)
        run.stats["knn_bound_ms_per_unit"] = fwd * roofline.knn_bound_ms(
            self.spec, 2 * self.tile_batch, False)
        t = run.part("weights", t)
        self.predict = build_predictor(self.model, self.mirror_axes, tile_batch=self.tile_batch,
                                       output="seg")
        self.served, self.times, self.next = [], [], 0
        for _ in range(2):
            self.predict(self.pool[0])
        run.sync()
        run.part("warmup", t)

    def unit(self):
        vol = self.pool[self.next % len(self.pool)]
        t = time.perf_counter()
        seg = self.predict(vol)  # a host array: the case has finished
        self.times.append(time.perf_counter() - t)
        self.served.append((self.next % len(self.pool), seg))
        self.next += 1

    def window(self, seconds: float) -> dict:
        run = self.run
        self.served, self.times, self.next = [], [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.unit()
        elapsed = time.perf_counter() - t0
        n = len(self.times)
        voxels = sum(math.prod(self.pool[i].shape[:-1]) for i, _ in self.served)
        run.attempted = n
        run.stats.update(window_s=elapsed, units=n,
                         latency_p95_s=float(np.percentile(self.times, 95)))
        self.window_served = list(self.served)
        times = sorted(self.times)
        bench.log(f"window: {n} cases in {elapsed:.3f} s; case seconds median "
                  f"{times[n // 2]:.4f}, min {times[0]:.4f}, max {times[-1]:.4f}")
        return {"serve_mvox_per_s": voxels / elapsed / 1e6}

    def after_trace(self):
        pass

    def close(self):
        pass

    def release(self):
        del self.model, self.predict
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list:
        n = int(self.run.cell["check_cases"])
        rng = np.random.default_rng(self.run.seed)
        served = self.window_served
        pick = rng.choice(len(served), size=min(n, len(served)), replace=False)
        return [served[i] for i in sorted(pick)]

    def gaps(self, net, sample) -> dict:
        """``sample``'s served labels against ``net``'s plain sliding window:
        the widest gap of a served label's probability below the largest
        (``prob_gap``), the share of voxels labelled otherwise
        (``label_mismatch``), and beside them the mean gap and the shares of
        voxels whose gap passes 0.01, 0.05 and 0.1."""
        gaps = []
        wrong = 0
        for i, seg in sample:
            vol = torch.from_numpy(self.pool[i]).to(self.run.device)
            probs = sliding.predict_probs(net, vol, self.patch, self.mirror_axes)
            lab = torch.from_numpy(np.asarray(seg, np.int64)).to(self.run.device)
            gaps.append((probs.amax(-1) - probs.gather(-1, lab[..., None])[..., 0]).flatten())
            wrong += int((probs.argmax(-1) != lab).sum())
            del probs
        g = torch.cat(gaps)
        out = {"prob_gap": g.max().item(), "label_mismatch": wrong / g.numel(),
               "mean_gap": g.mean().item()}
        for t in (0.01, 0.05, 0.1):
            out[f"share_gap_over_{t}"] = (g > t).float().mean().item()
        return out

    def check(self) -> list:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t = time.perf_counter()
        self.ref = self.reference_net()
        gaps = self.gaps(self.ref, self.sample())
        self.last_gaps = gaps
        lim = self.run.config["limits"]["serve"]
        bench.log(f"reference {time.perf_counter() - t:.1f} s over {len(self.sample())} cases; "
                  f"{json.dumps({k: v for k, v in gaps.items() if k not in lim})}")
        return [(name, gaps[name], limit) for name, limit in lim.items()]
