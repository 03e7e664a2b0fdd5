"""Profile one flagship NexToU forward on a CUDA card.

    python -m nextou_tpu_torch.tools.profile_forward [--conv-kernel {0,1,s1,s2}]

The forward of the serving path: ``3d_fullres_nextou`` with seeded random
weights, bf16, a batch of 4 patches (2 tiles x 2 mirror variants, as the
predictor runs it at tile batch 2). Prints the card (``nvidia-smi`` name and power limit), the
host-clock ms per forward, then ``torch.profiler``'s device time per forward
by kernel group, the device idle share of the profiled wall time, the
largest kernels and the peak device memory.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from nextou_tpu_torch.tools.timing import card, require_card

BATCH, WARMUP, TIMED, PROFILED, TOP = 4, 2, 5, 3, 20
# kernel name fragment -> group; the first match wins
GROUPS = (
    ("knn_max_kernel", "K1 knn_max"), ("conv3d_mma_kernel", "K5 conv3d"),
    ("conv3d_fma_kernel", "K5 conv3d"), ("pack_weights_kernel", "K5 conv3d"),
    ("conv", "conv (cuDNN)"), ("xmma", "conv (cuDNN)"), ("Nhwc", "conv (cuDNN)"),
    ("nhwc", "conv (cuDNN)"), ("nchw", "conv (cuDNN)"), ("sgemm", "conv (cuDNN)"),
    ("gemm", "matmul (cuBLAS)"),
    ("batch_norm", "norm"), ("instance_norm", "norm"), ("welford", "norm"),
    ("copy", "copy/layout/index"), ("roll", "copy/layout/index"),
    ("Cat", "copy/layout/index"), ("scatter", "copy/layout/index"),
    ("gather", "copy/layout/index"), ("index", "copy/layout/index"),
    ("Memset", "copy/layout/index"), ("reduce", "reduce"),
)


def profile(fn, n: int, groups=GROUPS, unit: str = "forward", top: int = TOP) -> None:
    """Run ``fn`` ``n`` times under ``torch.profiler`` and print, per run, the
    wall and device kernel time, the idle share of the wall time, the device
    time by kernel group (``groups``: name fragment -> group, the first
    match wins) and the ``top`` largest kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernel")
    per_name: dict[str, list] = {}
    for e in kernels:
        slot = per_name.setdefault(e.name, [0.0, 0])
        slot[0] += e.time_range.elapsed_us() / 1e3
        slot[1] += 1
    busy = sum(t for t, _ in per_name.values())
    by_group: dict[str, float] = {}
    for name, (t, _) in per_name.items():
        g = next((g for frag, g in groups if frag in name), "elementwise/other")
        by_group[g] = by_group.get(g, 0.0) + t
    print(f"profiled: wall {wall_ms / n:.1f} ms/{unit}, device kernel time "
          f"{busy / n:.1f} ms/{unit}, idle share {1 - busy / wall_ms:.3f}")
    for g, t in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:26s} {t / n:8.2f} ms  {t / busy:.3f}")
    for name, (t, c) in sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"  {t / n:8.2f} ms  x {c // n:4d}  {name[:110]}")


def conv_kernel_arg(description: str, argv=None) -> str:
    """The ``--conv-kernel`` mode of a profile's command line."""
    from nextou_tpu_torch.nn.conv_blocks import CONV_KERNEL_MODES

    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--conv-kernel", choices=CONV_KERNEL_MODES, default="0",
                    help="profile with the hand-written conv kernel on its region")
    return ap.parse_args(argv).conv_kernel


def main(argv=None) -> int:
    conv_kernel = conv_kernel_arg(__doc__.split("\n\n")[0], argv)
    if not require_card("profile_forward"):
        return 1
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.models.presets import flagship_3d_spec
    from nextou_tpu_torch.utils import init_weights

    dev = torch.device("cuda", 0)
    print(card())
    spec = flagship_3d_spec(num_classes=14, deep_supervision=False)
    model = init_weights(
        NexToU(spec, dtype=torch.bfloat16, conv_kernel=conv_kernel, device=dev), seed=0).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(BATCH, *spec.patch_size, spec.in_channels, generator=gen,
                    device=dev, dtype=torch.bfloat16)

    def forward():
        with torch.inference_mode():
            model(x)

    for _ in range(WARMUP):
        forward()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(TIMED):
        forward()
    torch.cuda.synchronize()
    print(f"forward batch {BATCH} bf16, conv_kernel={conv_kernel}: {(time.perf_counter() - t0) / TIMED * 1e3:.1f} ms "
          f"(host clock, {TIMED} forwards)")

    profile(forward, PROFILED)
    print(f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
