"""Profile the flagship NexToU train step on a CUDA card.

    python -m nextou_tpu_torch.tools.profile_train

The train step of ``chip_smoke.py``: ``3d_fullres_nextou`` with deep
supervision and seeded random weights, batch 2, bf16 compute and f32
parameters, Dice + CE, SGD. Prints the card (``nvidia-smi`` name and power
limit), the host-clock seconds per step, then ``torch.profiler``'s device
time per step by kernel group, the device idle share of the profiled wall
time, the largest kernels and the peak device memory.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from nextou_tpu_torch.tools.profile_forward import GROUPS as FORWARD_GROUPS
from nextou_tpu_torch.tools.profile_forward import profile

BATCH, WARMUP, TIMED, PROFILED, TOP = 2, 2, 3, 2, 25
# kernel name fragment -> group; the first match wins
GROUPS = (
    ("knn_idx_kernel", "K3 knn_max_idx"), ("bwd_share_kernel", "K4 knn_max_bwd"),
    ("bwd_reduce_kernel", "K4 knn_max_bwd"), ("dgrad", "conv (cuDNN)"),
    ("wgrad", "conv (cuDNN)"), ("multi_tensor", "optimizer (_foreach)"),
    ("softmax", "loss (softmax)"), *FORWARD_GROUPS,
)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_train: no CUDA card visible", file=sys.stderr)
        return 1
    from nextou_tpu_torch.losses import CompoundLossSpec, deep_supervision_weights
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.models.presets import flagship_3d_spec
    from nextou_tpu_torch.train import (
        create_train_state, make_optimizer, make_train_step, poly_lr,
    )

    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip())
    spec = flagship_3d_spec(num_classes=14, deep_supervision=True)
    model = NexToU(spec, dtype=torch.bfloat16, device=dev)
    opt = make_optimizer(poly_lr(1e-2, 1000, 0.9, steps_per_epoch=250))
    state = create_train_state(model, opt, seed=0)
    step = make_train_step(model, opt, CompoundLossSpec(),
                           deep_supervision_weights(len(spec.decoder)))
    rng = np.random.default_rng(20)
    batch = {
        "data": torch.from_numpy(
            rng.standard_normal((BATCH, *spec.patch_size, 1), dtype=np.float32)).to(dev),
        "seg": torch.from_numpy(
            rng.integers(0, spec.num_classes, (BATCH, *spec.patch_size))).to(dev),
    }

    for _ in range(WARMUP):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(TIMED):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    print(f"train step batch {BATCH} bf16, Dice+CE: "
          f"{(time.perf_counter() - t0) / TIMED:.4f} s (host clock, {TIMED} steps)")
    print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    # the step updates the state in place
    profile(lambda: step(state, batch), PROFILED, GROUPS, unit="step", top=TOP)
    return 0


if __name__ == "__main__":
    sys.exit(main())
