"""K4, the kNN max backward, per flagship train shape and per pass, on a CUDA card.

    python -m nextou_tpu_torch.tools.exp_knn_bwd [--json PATH]

At each kNN shape of one flagship train step (batch 2; the shapes and their
calls per step are ``SHAPES``), with bf16 and f32 values: K3 selects on
seeded normalized f32 coordinates, then ``knn_max_bwd_cuda`` runs on K3's
own indices. Prints, per shape, K4's time by CUDA events, its device time
by kernel name under ``torch.profiler`` (each pass of the kernel apart,
memsets included), the bound (the bytes of yv, idx, maxv, g and gy at 3.35
TB/s) and the error against the plain version; then the sums per train
step. ``--json`` also writes the numbers to a file.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import torch

from nextou_tpu_torch.tools.timing import card, cuda_ms, require_card

# (B, N, M, C, k, self_graph, calls per step): the flagship's 14 graphers at
# batch 2 (chip_smoke.py's knn_calls of flagship_3d_spec at TRAIN_BATCH)
SHAPES = (
    ("s2 pool", 2, 10752, 168, 132, 14, False, 2),
    ("s2 swin", 1024, 168, 168, 132, 7, True, 2),
    ("s3 pool", 2, 10752, 1344, 264, 28, False, 2),
    ("s3 swin", 128, 168, 168, 264, 14, True, 2),
    ("s4 pool", 2, 1344, 1344, 324, 32, False, 2),
    ("s4 swin", 16, 168, 168, 324, 14, True, 2),
    ("s5 k32", 2, 168, 168, 324, 32, True, 1),
    ("s5 k28", 2, 168, 168, 324, 28, True, 1),
)
PEAK_BYTES_S = 3.35e12
ITERS = 10


def inputs(B, N, M, C, k, self_graph, values, dev, seed=0):
    """Seeded candidate values in ``values``, K3's indices and f32 max on
    normalized f32 coordinates, and an f32 cotangent."""
    from nextou_tpu_torch.core.graph import l2_normalize
    from nextou_tpu_torch.kernels.knn import knn_max_idx_cuda

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, N, C, generator=gen, device=dev)
    y = x if self_graph else torch.randn(B, M, C, generator=gen, device=dev)
    xn = l2_normalize(x).contiguous()
    yn = xn if self_graph else l2_normalize(y).contiguous()
    yv = y.to(values).contiguous()
    maxv, idx = knn_max_idx_cuda(xn, yn, yv, None, k)
    g = torch.randn(B, N, C, generator=gen, device=dev)
    return yv, idx, maxv, g


class NoDeviceEvents(RuntimeError):
    """The profiler recorded no device kernel in any of its tries."""


def device_ms_by_kernel(fn, n: int) -> dict[str, float]:
    """Device milliseconds per call of ``fn`` by kernel name (memsets too)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profile now and then records no device event: again
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # "void (anonymous namespace)::bwd_walk_kernel<float, 8>(...)" -> its name
                m = re.search(r"(\w+)(?:<[^(]*>)?\(", e.name)
                name = m.group(1) if m else e.name
                out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / n
        if out:
            return out
    raise NoDeviceEvents("the profiler recorded no device kernel")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the numbers to this file")
    args = ap.parse_args(argv)
    if not require_card("exp_knn_bwd"):
        return 1
    from nextou_tpu_torch.kernels.knn import knn_max_bwd_cuda, knn_max_bwd_reference

    dev = torch.device("cuda", 0)
    smi = card()
    print(smi)
    rows, step = [], {}
    for tag, B, N, M, C, k, self_graph, calls in SHAPES:
        for values in (torch.bfloat16, torch.float32):
            yv, idx, maxv, g = inputs(B, N, M, C, k, self_graph, values, dev)
            gy = knn_max_bwd_cuda(yv, idx, maxv, g, k)
            want = knn_max_bwd_reference(yv, idx, maxv, g, k)
            err = (gy - want).abs().max().item()
            same = torch.equal(gy, knn_max_bwd_cuda(yv, idx, maxv, g, k))
            ms = cuda_ms(lambda: knn_max_bwd_cuda(yv, idx, maxv, g, k), iters=ITERS)
            passes = device_ms_by_kernel(lambda: knn_max_bwd_cuda(yv, idx, maxv, g, k), ITERS)
            moved = sum(t.numel() * t.element_size() for t in (yv, idx, maxv, g, gy))
            bound = moved / PEAK_BYTES_S * 1e3
            dt = str(values)[6:]
            print(f"{tag} (B={B} N={N} M={M} C={C} k={k}) values {dt} x{calls}: "
                  f"K4 {ms:.4f} ms, bound {bound:.4f} ms, max|err| {err:.3g}, "
                  f"same bits twice {same}; device: "
                  + ", ".join(f"{n} {t:.4f}" for n, t in passes.items()), flush=True)
            if not same:
                raise AssertionError(f"K4 gave other bits on a second launch at {tag}")
            rows.append({"shape": tag, "values": dt, "calls": calls, "ms": ms,
                         "bound_ms": bound, "max_abs_err": err, "passes": passes})
            tot = step.setdefault(dt, {"ms": 0.0, "bound_ms": 0.0, "passes": {}})
            tot["ms"] += calls * ms
            tot["bound_ms"] += calls * bound
            for n, t in passes.items():
                tot["passes"][n] = tot["passes"].get(n, 0.0) + calls * t
            del yv, idx, maxv, g, gy, want
            torch.cuda.empty_cache()
    for dt, tot in step.items():
        print(f"per train step (values {dt}): K4 {tot['ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms; device: "
              + ", ".join(f"{n} {t:.3f}" for n, t in tot["passes"].items()))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "shapes": rows, "per_step": step}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
