"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases (each prints its lines; any failure raises and exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build K1 (``nextou_tpu_torch/csrc/knn_max.cu``) with nvcc for sm_90a;
3. K1 against its plain PyTorch version at every kNN shape of one flagship
   forward on the serving path (2 tiles x 2 mirror variants = batch 4), in
   bf16 and in f32. Tolerance: at most 0.1% of output rows may differ, and
   every row that differs must be a near tie of the plain version (its k-th
   and (k+1)-th distances within 1e-4: f32 accumulation-order noise over
   C <= 324 terms; bf16 products are exact in f32). The share is taken over
   at least 10,000 rows per shape: a small shape is drawn again with fresh
   seeded inputs until it has that many. Times by CUDA events;
4. the slice: a ``3d_fullres_nextou`` plans folder, two seeded 1x64x280x240
   cases and a seeded flagship checkpoint go through
   ``nextou_tpu_torch.predict.main`` with 8-way mirror TTA, tile batch 2, in
   bf16; K1's launch count must be 14 per forward; then seconds per volume,
   peak device memory, and the probabilities of one case (finite, summing
   to 1);
5. a small network predicted on the card in f32 against the same network on
   the CPU (plain kNN), as the reference on a small input.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the kernels' JSON record. Without a CUDA card the script fails.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the near-tie bound of phase 3, the row share allowed to differ, and the
# fewest rows that share is taken over
TIE_GAP, MAX_ROWS_OFF, MIN_ROWS = 1e-4, 1e-3, 10_000
TILE_BATCH, MIRRORS_PER_FORWARD = 2, 2


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def flagship_knn_calls(spec, batch: int) -> dict:
    """(B, N, M, C, k, self_graph) -> calls per forward, from the spec the
    way the model builds its graphers."""
    calls: dict = {}
    for st in (*spec.encoder, *spec.decoder):
        for b in st.gnn:
            C = st.features
            if b.kind == "pool":
                pooled = [s // p for s, p in zip(st.img_shape, b.pool_size)]
                n = math.prod(pooled)
                m = math.prod(s // b.reduce_ratio for s in pooled)
                key = (batch, n, m, C, b.k, b.reduce_ratio == 1)
            else:
                windows = math.prod(s // w for s, w in zip(st.img_shape, b.window_size))
                n = math.prod(b.window_size)
                key = (batch * windows, n, n, C, b.k, True)
            calls[key] = calls.get(key, 0) + 1
    return calls


def kernel_phase(spec, dev) -> dict:
    from nextou_tpu_torch.core.graph import knn_sq_dist
    from nextou_tpu_torch.core.pos_embed import relative_pos_bias
    from nextou_tpu_torch.kernels.knn import (
        _normalized, knn_max_neighbors, knn_max_neighbors_reference,
    )

    calls = flagship_knn_calls(spec, TILE_BATCH * MIRRORS_PER_FORWARD)
    assert sum(calls.values()) == 14, calls
    gen = torch.Generator(device=dev).manual_seed(0)
    ms = {torch.bfloat16: 0.0, torch.float32: 0.0}
    plain_ms = dict(ms)
    max_err = 0.0
    for (B, N, M, C, k, self_graph), count in calls.items():
        rel = torch.tensor(relative_pos_bias(C, N, M, 3), device=dev)
        # the row share is a rate: small shapes draw fresh inputs until
        # MIN_ROWS rows are compared (one near tie in 672 rows is 0.15%)
        draws = math.ceil(MIN_ROWS / (B * N))
        for dtype in (torch.bfloat16, torch.float32):
            rows_off = worst_gap = err = 0
            for _ in range(draws):
                x = torch.randn(B, N, C, generator=gen, device=dev).to(dtype)
                y = None if self_graph else torch.randn(
                    B, M, C, generator=gen, device=dev).to(dtype)
                got = knn_max_neighbors(x, k, y, rel)
                want = knn_max_neighbors_reference(x, k, y, rel).to(dtype)
                assert got.shape == want.shape == (B, N, C) and got.dtype == dtype
                assert torch.isfinite(got.float()).all()
                off = (got != want).any(-1)
                rows_off += int(off.sum())
                xn, yn = _normalized(x, y)
                near = torch.topk(knn_sq_dist(xn, None if y is None else yn, rel),
                                  k + 1, dim=-1, largest=False).values
                gaps = (near[..., k] - near[..., k - 1])[off]
                worst_gap = max(worst_gap, gaps.max().item() if gaps.numel() else 0.0)
                err = max(err, (got.float() - want.float()).abs().max().item())
                del got, want, near
            share = rows_off / (draws * B * N)
            max_err = max(max_err, err)
            t_k1 = cuda_ms(lambda: knn_max_neighbors(x, k, y, rel))
            t_plain = cuda_ms(lambda: knn_max_neighbors_reference(x, k, y, rel))
            ms[dtype] += count * t_k1
            plain_ms[dtype] += count * t_plain
            tfma = B * N * M * C / (t_k1 * 1e-3) / 1e12
            print(
                f"K1 B={B} N={N} M={M} C={C} k={k} {str(dtype)[6:]} x{count}: "
                f"rows off {rows_off}/{draws * B * N} = {share:.2e} "
                f"(worst k/k+1 gap {worst_gap:.2e}) max|err| {err:.3g}  "
                f"K1 {t_k1:.3f} ms ({tfma:.2f} TFMA/s)  plain {t_plain:.3f} ms"
            )
            if share > MAX_ROWS_OFF or worst_gap > TIE_GAP:
                raise AssertionError(f"K1 disagrees with the plain version at {B, N, M, C, k}")
        torch.cuda.empty_cache()
    for dtype in ms:
        print(f"K1 per flagship forward ({str(dtype)[6:]}): {ms[dtype]:.3f} ms, "
              f"plain {plain_ms[dtype]:.3f} ms")
    return {"ms": ms[torch.bfloat16], "plain_ms": plain_ms[torch.bfloat16],
            "max_abs_err": max_err}


def write_dataset(folder: str, spec, configuration: str, cases: int, shape, seed: int):
    """A preprocessed dataset folder (plans, dataset.json, cases) for ``spec``,
    in the plans format nnU-Net writes; each case is ``{case}.npz`` with
    ``data`` (C, *sp) f32 and ``seg`` (*sp) int16, the preprocessed layout."""
    cfg = {
        "batch_size": 2, "patch_size": list(spec.patch_size),
        "spacing": [1.0] * spec.spatial_dims,
        "normalization_schemes": ["CTNormalization"], "use_mask_for_norm": [False],
        "UNet_class_name": "PlainConvUNet",
        "UNet_base_num_features": spec.encoder[0].features,
        "unet_max_num_features": max(st.features for st in spec.encoder),
        "n_conv_per_stage_encoder": [st.n_conv + bool(st.gnn) for st in spec.encoder],
        "n_conv_per_stage_decoder": [st.n_conv + bool(st.gnn) for st in spec.decoder],
        "pool_op_kernel_sizes": [list(st.stride) for st in spec.encoder],
        "conv_kernel_sizes": [list(st.kernel_size) for st in spec.encoder],
        "batch_dice": True,
    }
    plans = {"dataset_name": "Dataset999_Smoke", "plans_name": "nnUNetPlans",
             "configurations": {configuration: cfg}}
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(plans, f)
    labels = {"background": 0, **{f"organ{i}": i for i in range(1, spec.num_classes)}}
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump({"labels": labels, "numTraining": cases, "channel_names": {"0": "CT"},
                   "file_ending": ".nii.gz"}, f)
    rng = np.random.default_rng(seed)
    for i in range(cases):
        np.savez(os.path.join(folder, f"case_{i:03d}.npz"),
                 data=rng.standard_normal((1, *shape), dtype=np.float32),
                 seg=np.zeros(shape, np.int16))


def slice_phase(dev, tmp: str, spec, shape) -> dict:
    from nextou_tpu_torch import predict
    from nextou_tpu_torch.infer.sliding_window import compute_sliding_window_steps
    from nextou_tpu_torch.kernels.knn import knn_max_cuda
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.utils import init_weights

    n_cases, config = 2, "3d_fullres_nextou"
    data_dir, model_dir, out_dir = (os.path.join(tmp, d) for d in ("data", "model", "out"))
    os.makedirs(data_dir)
    os.makedirs(model_dir)
    write_dataset(data_dir, spec, config, n_cases, shape, seed=1)
    t0 = time.time()
    model = init_weights(NexToU(spec, device=dev), seed=0)
    torch.save({"network_weights": model.state_dict()},
               os.path.join(model_dir, "checkpoint_final.pth"))
    del model
    print(f"flagship checkpoint (seed 0) built and saved in {time.time() - t0:.1f} s")

    tiles = math.prod(len(s) for s in compute_sliding_window_steps(shape, spec.patch_size))
    forwards = n_cases * math.ceil(tiles / TILE_BATCH) * (8 // MIRRORS_PER_FORWARD)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    knn_max_cuda.launches = 0
    t0 = time.time()
    predict.main([model_dir, data_dir, config, "-tr", "nnUNetTrainer_NexToU",
                  "-o", out_dir, "--tile-batch", str(TILE_BATCH), "--device", str(dev)])
    torch.cuda.synchronize()
    main_s = time.time() - t0
    launches = knn_max_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"predict.main: {n_cases} volumes {shape}, {tiles} tiles each, "
          f"{forwards} forwards, {main_s:.2f} s incl. model build and load; "
          f"K1 launches {launches}; peak device memory {peak / 2**30:.2f} GiB")
    if launches != 14 * forwards:
        raise AssertionError(f"K1 launched {launches} times for {forwards} forwards")
    segs = []
    for i in range(n_cases):
        with np.load(os.path.join(out_dir, f"case_{i:03d}.npz")) as z:
            seg = z["seg"]
        assert seg.shape == shape and seg.dtype == np.uint8, (seg.shape, seg.dtype)
        assert seg.max() < spec.num_classes
        segs.append(seg)
        print(f"case_{i:03d}: seg {seg.shape} labels {np.unique(seg).tolist()}")

    # steady-state seconds per volume, and the probabilities of one case
    plans, _, infer_spec = predict.load_dataset(data_dir, config)
    model = predict.load_model(infer_spec, os.path.join(model_dir, "checkpoint_final.pth"), dev)
    cases = [data for _, data in predict.iter_cases(data_dir, plans, config)]
    seg_pred = predict.build_predictor(model, (0, 1, 2), tile_batch=TILE_BATCH, output="seg")
    times = []
    for data in cases:
        torch.cuda.synchronize()
        t0 = time.time()
        seg_pred(data)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    print(f"seconds per volume (8-way TTA, tile batch {TILE_BATCH}, bf16): "
          f"{', '.join(f'{t:.3f}' for t in times)}")
    probs = predict.build_predictor(model, (0, 1, 2), tile_batch=TILE_BATCH)(cases[0])
    assert probs.shape == (*shape, spec.num_classes) and np.isfinite(probs).all()
    sums = probs.sum(-1)
    agree = float(np.mean(np.argmax(probs, -1) == segs[0]))
    print(f"probabilities: sum in [{sums.min():.6f}, {sums.max():.6f}], "
          f"argmax agrees with main's seg on {agree:.6f} of voxels")
    assert np.abs(sums - 1).max() <= 1e-3
    assert agree >= 0.99
    return {"launches": launches, "s_per_volume": min(times), "peak_bytes": peak}


def small_reference_phase(dev):
    """A small network (seeded) predicted on the card in f32 with K1 against
    the same network on the CPU with the plain kNN.

    The He-normal kernels are halved, as in the CPU tests: with identity
    running statistics, full-scale kernels grow the logits to ~1e5, and then
    f32 rounding alone (f32 against f64 on one CPU) moves the softmax and
    flips kNN near ties, so no tolerance would separate a fault from noise.
    """
    from nextou_tpu_torch.infer import make_device_sliding_predictor
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.models.presets import small_3d_spec
    from nextou_tpu_torch.utils import init_weights

    spec = small_3d_spec(num_classes=3, deep_supervision=False)
    data = np.random.default_rng(2).standard_normal((16, 120, 100, 1)).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        model = init_weights(NexToU(spec, device=d), seed=3).eval()
        with torch.no_grad():
            for p in model.parameters():
                if p.dim() >= 2:
                    p.mul_(0.5)
        out[d.type] = make_device_sliding_predictor(
            model, (0, 1, 2), spec.patch_size, spec.num_classes, device=d,
            tile_batch=TILE_BATCH, transfer_dtype=torch.float32,
        )(data).cpu().numpy()
    got, want = out["cuda"], out["cpu"]
    off = np.abs(got - want) > 2e-3 + 1e-3 * np.abs(want)
    agree = float(np.mean(np.argmax(got, -1) == np.argmax(want, -1)))
    print(f"small network f32, card vs CPU: max|diff| {np.abs(got - want).max():.3g}, "
          f"{off.mean():.2e} of values outside atol 2e-3/rtol 1e-3, seg agreement {agree:.6f}")
    if off.mean() > 1e-3 or agree < 0.999:
        raise AssertionError("the port on the card disagrees with the CPU reference")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    from nextou_tpu_torch.kernels.knn import build_knn_max
    from nextou_tpu_torch.models.presets import flagship_3d_spec

    # f32 comparisons are full f32: no TF32 in matmuls or cuDNN convs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = card()
    print(f"card: {smi} | torch.cuda: {name} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.time()
    log = build_knn_max()
    print(f"K1 built in {time.time() - t0:.1f} s from nextou_tpu_torch/csrc/knn_max.cu "
          f"(nvcc -gencode arch=compute_90a,code=sm_90a)")
    print("\n".join(line for line in log.splitlines() if "knn_max" in line or "Used" in line))

    record = kernel_phase(flagship_3d_spec(), dev)
    with tempfile.TemporaryDirectory() as tmp:
        # two cases of 64x280x240: 2 x 2 tiles of the 64x224x192 patch each
        sl = slice_phase(dev, tmp, flagship_3d_spec(num_classes=14), (64, 280, 240))
    small_reference_phase(dev)

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "knn_max", "route": "cuda",
        "source": "nextou_tpu_torch/csrc/knn_max.cu",
        "replaces": "nextou_tpu/kernels/knn.py:40",
        "launches": sl["launches"], "max_abs_err": record["max_abs_err"],
        "ms": record["ms"], "plain_ms": record["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
