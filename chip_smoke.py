"""Smoke run of the PyTorch port on one CUDA card: ``python3 chip_smoke.py``.

Phases (each prints its lines; any failure raises and exits non-zero):

1. the card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build the kernels (``nextou_tpu_torch/csrc/*.cu``), one nvcc per source
   and all started together, for sm_90a;
3. K1 (inference forward) against its plain PyTorch version at every kNN
   shape of one flagship forward on the serving path (2 tiles x 2 mirror
   variants = batch 4), in bf16 and in f32. Tolerance: at most 0.1% of
   output rows may differ, and every row that differs must be a near tie of
   the plain version (its k-th and (k+1)-th distances within 1e-4: f32
   accumulation-order noise over C <= 324 terms; bf16 products are exact in
   f32). The share is taken over at least 10,000 rows per shape: a small
   shape is drawn again with fresh seeded inputs until it has that many;
4. K2 (indices), K3 (training forward: max and indices) and K4 (backward)
   at every kNN shape of one flagship train step at batch 2, f32
   coordinates with bf16 and with f32 values. K2's indices equal to K3's
   everywhere, and held against the plain version's row by row: a row may
   differ as a set only on a near tie of phase 3, and in its order alone only
   where two of its k nearest are within 1e-4; at most 0.1% of the rows
   differ as sets and 1% in their order alone. K3's max bit-equal to the plain version's wherever the set
   is. K4 against its plain version on K3's own indices, within rtol 1e-5
   and atol 1e-6 + 2e-6 x the sum of the absolute contributions to that
   entry (a pooled candidate receives hundreds of f32 contributions, which
   the plain version's ``index_add_`` adds in another order), bit-exact
   where every candidate receives one contribution, and non-zero for bf16
   queries with f32 candidates. Every time beside its bound: the larger of
   the bytes moved at 3.35 TB/s and the operations at the card's peak for
   their type. No flagship graph is dilated, so K2 never runs at these
   shapes: its record comes from the shapes of the small dilated network of
   phase 8 (``k * dilation`` neighbours), held against the plain version
   there in the same way;
5. the serving slice: a ``3d_fullres_nextou`` plans folder, two seeded
   1x64x280x240 cases and a seeded flagship checkpoint go through
   ``nextou_tpu_torch.predict.main`` with 8-way mirror TTA, tile batch 2, in
   bf16; K1's launch count must be 14 per forward; then seconds per volume,
   peak device memory, and the probabilities of one case;
6. a small network predicted on the card in f32 against the CPU;
7. the training slice: the flagship with deep supervision, batch 2, bf16
   compute and f32 parameters, takes 3 optimizer steps with Dice + CE and 2
   with the BTI Synapse loss, then one eval step. Losses and gradient norms
   finite, every parameter moved (but the biases under a normalization and
   the zero-weight head's) and the BatchNorm statistics too, K3 and K4 launched 14
   times per step, the eval statistics consistent; seconds per step, patches
   per second, peak device memory; then two steps with every stage
   recomputed in the backward pass (K3 launched 28 times per step, K4 14);
8. a small network trained for 2 steps on the card (K3, K4, and K2 through
   one dilated stage) against the same 2 steps on the CPU (plain versions),
   each step from the same state.

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the kernels' JSON record, each entry with the path its numbers were taken
on. An index kernel's ``max_abs_err`` is the largest difference between the
distances of its neighbours and the plain version's. Without a CUDA card the script fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the near-tie bound of phases 3 and 4, the row share allowed to differ (in
# its set of neighbours; in their order alone), and the fewest rows that
# share is taken over
TIE_GAP, MAX_ROWS_OFF, MAX_ROWS_REORDERED, MIN_ROWS = 1e-4, 1e-3, 1e-2, 10_000
TILE_BATCH, MIRRORS_PER_FORWARD = 2, 2
TRAIN_BATCH = 2
# the card's published peaks (H100 SXM): device memory, bf16 tensor cores,
# f32 outside the tensor cores
PEAK_BYTES_S, PEAK_BF16_FLOPS, PEAK_F32_FLOPS = 3.35e12, 989e12, 67e12

# the BTCV/Synapse 13-organ binary interaction tree of upstream's
# nnUNetTrainer_NexToU_BTI_Synapse (exclusion pairs of label sets)
BTI_SYNAPSE_EXCLUSION = [
    [[1, 3, 5, 7, 8, 11, 13], [2, 4, 6, 9, 10, 12]],
    [[1, 3, 11, 13], [5, 7, 8]],
    [[1, 3], [11, 13]],
    [1, 3],
    [11, 13],
    [[5, 8], [7]],
    [5, 8],
    [[4, 6, 10], [2, 9, 12]],
    [[4, 6], [10]],
    [4, 6],
    [[9, 12], [2]],
    [9, 12],
]


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


def nbytes(*tensors) -> int:
    """Bytes of the given tensors, each storage once (a self-graph passes one
    tensor as queries and candidates); ``None`` entries skipped."""
    seen = {t.data_ptr(): t.numel() * t.element_size() for t in tensors if t is not None}
    return sum(seen.values())


def bound_ms(moved: int, flops: float, peak_flops: float = PEAK_F32_FLOPS):
    """The least time the card could take: ``moved`` bytes (every input read
    once, every output written once) at the card's memory rate, or ``flops``
    at ``peak_flops``, whichever is larger. Returns (ms, 'bytes' | 'operations')."""
    by_bytes, by_ops = moved / PEAK_BYTES_S * 1e3, flops / peak_flops * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


class Totals:
    """Per-kernel sums over the shapes of one pass of the main path."""

    def __init__(self):
        self.ms = self.plain_ms = self.bound_ms = self.max_abs_err = 0.0
        self.by = {"bytes": 0.0, "operations": 0.0}

    def add(self, count, ms, plain_ms, bound, by, err):
        self.ms += count * ms
        self.plain_ms += count * plain_ms
        self.bound_ms += count * bound
        self.by[by] += count * bound
        self.max_abs_err = max(self.max_abs_err, err)

    def record(self) -> dict:
        return {"max_abs_err": self.max_abs_err, "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms, "bound_by": max(self.by, key=self.by.get),
                # no single PyTorch call computes kNN + gather + max, its
                # indices, or its backward
                "library_ms": None}


def knn_calls(spec, batch: int, dilated: bool = False) -> dict:
    """(B, N, M, C, k, self_graph) -> calls per forward, from the spec the
    way the model builds its graphers: the fused graphs (dilation 1: K1, or
    K3 and K4), or with ``dilated`` the others (K2), whose ``k`` is the
    ``k * dilation`` neighbours that the kernel selects."""
    calls: dict = {}
    for st in (*spec.encoder, *spec.decoder):
        for b in st.gnn:
            if (b.dilation > 1) != dilated:
                continue
            C = st.features
            if b.kind == "pool":
                pooled = [s // p for s, p in zip(st.img_shape, b.pool_size)]
                n = math.prod(pooled)
                m = math.prod(s // b.reduce_ratio for s in pooled)
                key = (batch, n, m, C, b.k * b.dilation, b.reduce_ratio == 1)
            else:
                windows = math.prod(s // w for s, w in zip(st.img_shape, b.window_size))
                n = math.prod(b.window_size)
                key = (batch * windows, n, n, C, b.k * b.dilation, True)
            calls[key] = calls.get(key, 0) + 1
    return calls


def near_tie_gaps(xn, yn, rel, k, rows):
    """The gap between the k-th and the (k+1)-th distance of the plain
    version, at the rows of the boolean mask ``rows``."""
    from nextou_tpu_torch.core.graph import knn_sq_dist

    near = torch.topk(knn_sq_dist(xn, yn, rel), k + 1, dim=-1, largest=False).values
    return (near[..., k] - near[..., k - 1])[rows]


class Selection:
    """A kernel's ``(B, N, k)`` indices held against the plain version's,
    summed over the draws of one shape. A row may differ only where the plain
    version's own distances nearly tie: as a set where the k-th and the
    (k+1)-th are within ``TIE_GAP`` (at most ``MAX_ROWS_OFF`` of the rows),
    in its order alone where two neighbouring ones of the k nearest are (at
    most ``MAX_ROWS_REORDERED``: a row has k - 1 such pairs, and the order
    inside the set reaches no max). ``dist_err`` is the largest difference,
    position by position, between the distances of the kernel's neighbours
    and of the plain version's."""

    def __init__(self):
        self.rows = self.rows_off = self.rows_reordered = 0
        self.worst_gap = self.dist_err = 0.0

    def add(self, xn, yn, rel, k, idx, want_idx):
        from nextou_tpu_torch.core.graph import knn_sq_dist

        dist = knn_sq_dist(xn, yn, rel)
        near = torch.topk(dist, min(k + 1, dist.shape[-1]), dim=-1, largest=False).values
        step = torch.nn.functional.pad(near[..., 1:] - near[..., :-1], (0, 2), value=math.inf)
        other_set = (idx.sort(-1).values != want_idx.sort(-1).values).any(-1)
        other_order = (idx != want_idx).any(-1) & ~other_set
        gaps = torch.cat([step[..., k - 1][other_set],
                          step[..., :k - 1].amin(-1)[other_order]]) if k > 1 else step[..., 0][other_set]
        self.rows += other_set.numel()
        self.rows_off += int(other_set.sum())
        self.rows_reordered += int(other_order.sum())
        self.worst_gap = max(self.worst_gap, gaps.max().item() if gaps.numel() else 0.0)
        got = dist.gather(2, idx.long())
        self.dist_err = max(self.dist_err, (got - near[..., :k]).abs().max().item())
        return other_set

    @property
    def share(self) -> float:
        return self.rows_off / self.rows

    def check(self, name, shape):
        if (self.share > MAX_ROWS_OFF or self.rows_reordered > MAX_ROWS_REORDERED * self.rows
                or self.worst_gap > TIE_GAP):
            raise AssertionError(f"{name} selects other neighbours than the plain version at {shape}")

    def __str__(self):
        return (f"rows off {self.rows_off}/{self.rows} = {self.share:.2e}, "
                f"{self.rows_reordered} more in their order alone "
                f"(worst gap {self.worst_gap:.2e}, max|distance err| {self.dist_err:.3g})")


def kernel_phase(spec, dev) -> Totals:
    from nextou_tpu_torch.core.pos_embed import relative_pos_bias
    from nextou_tpu_torch.kernels.knn import (
        _normalized, knn_max_neighbors, knn_max_neighbors_reference,
    )

    calls = knn_calls(spec, TILE_BATCH * MIRRORS_PER_FORWARD)
    assert sum(calls.values()) == 14, calls
    gen = torch.Generator(device=dev).manual_seed(0)
    totals = {torch.bfloat16: Totals(), torch.float32: Totals()}
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
                gaps = near_tie_gaps(xn, None if y is None else yn, rel, k, off)
                worst_gap = max(worst_gap, gaps.max().item() if gaps.numel() else 0.0)
                err = max(err, (got.float() - want.float()).abs().max().item())
                del got, want
            share = rows_off / (draws * B * N)
            t_k1 = cuda_ms(lambda: knn_max_neighbors(x, k, y, rel))
            t_plain = cuda_ms(lambda: knn_max_neighbors_reference(x, k, y, rel))
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
            # K1 reads the coordinates, the values (the raw features in the
            # coordinates' dtype: a tensor of its own) and the bias, and
            # writes the f32 max
            vals = x if y is None else y
            moved = nbytes(xn, yn, rel) + vals.numel() * xn.element_size() + B * N * C * 4
            bound, by = bound_ms(moved, 2.0 * B * N * M * C, peak)
            totals[dtype].add(count, t_k1, t_plain, bound, by, err)
            print(
                f"K1 B={B} N={N} M={M} C={C} k={k} {str(dtype)[6:]} x{count}: "
                f"rows off {rows_off}/{draws * B * N} = {share:.2e} "
                f"(worst k/k+1 gap {worst_gap:.2e}) max|err| {err:.3g}  "
                f"K1 {t_k1:.3f} ms  plain {t_plain:.3f} ms  bound {bound:.4f} ms ({by})"
            )
            if share > MAX_ROWS_OFF or worst_gap > TIE_GAP:
                raise AssertionError(f"K1 disagrees with the plain version at {B, N, M, C, k}")
        torch.cuda.empty_cache()
    for dtype, t in totals.items():
        print(f"K1 per flagship forward ({str(dtype)[6:]}): {t.ms:.3f} ms, "
              f"plain {t.plain_ms:.3f} ms, bound {t.bound_ms:.3f} ms")
    return totals[torch.bfloat16]


def order_unambiguous_case(dev, seed=7, n=16, k=3, c=8):
    """N queries, each with k nearest candidates of its own, disjoint from
    every other query's (M = N * k clusters): each candidate receives exactly
    one contribution, so no add order can change the gradient."""
    rng = np.random.default_rng(seed)
    qs = rng.standard_normal((1, n, c)).astype(np.float32) * 10
    cands = np.repeat(qs[0], k, axis=0) + 0.01 * rng.standard_normal((n * k, c)).astype(np.float32)
    g = rng.standard_normal((1, n, c)).astype(np.float32)
    return (torch.from_numpy(a).to(dev) for a in (qs, cands[None], g)), k


def train_kernel_phase(spec, dev) -> dict[str, Totals]:
    from nextou_tpu_torch.core.graph import l2_normalize
    from nextou_tpu_torch.core.pos_embed import relative_pos_bias
    from nextou_tpu_torch.kernels.knn import (
        knn_indices_cuda, knn_indices_reference, knn_max_bwd_cuda, knn_max_bwd_reference,
        knn_max_idx_cuda, knn_max_idx_reference, knn_max_neighbors,
    )

    calls = knn_calls(spec, TRAIN_BATCH)
    assert sum(calls.values()) == 14, calls
    gen = torch.Generator(device=dev).manual_seed(10)
    totals = {
        name: {torch.bfloat16: Totals(), torch.float32: Totals()}
        for name in ("knn_max_idx", "knn_max_bwd")
    }
    for (B, N, M, C, k, self_graph), count in calls.items():
        rel = torch.tensor(relative_pos_bias(C, N, M, 3), device=dev).contiguous()
        draws = math.ceil(MIN_ROWS / (B * N))
        for dtype in (torch.bfloat16, torch.float32):
            err3 = err4 = worst4 = 0.0
            sel = Selection()
            for _ in range(draws):
                x = torch.randn(B, N, C, generator=gen, device=dev).to(dtype)
                y = x if self_graph else torch.randn(
                    B, M, C, generator=gen, device=dev).to(dtype)
                # a train step selects on f32 coordinates whatever the model's dtype
                xn = l2_normalize(x.float()).contiguous()
                yn = xn if self_graph else l2_normalize(y.float()).contiguous()
                yv = y.contiguous()
                g = torch.randn(B, N, C, generator=gen, device=dev)
                maxv, idx3 = knn_max_idx_cuda(xn, yn, yv, rel, k)
                idx2 = knn_indices_cuda(xn, yn, rel, k)
                gy = knn_max_bwd_cuda(yv, idx3, maxv, g, k)
                torch.cuda.synchronize()
                assert maxv.shape == (B, N, C) and maxv.dtype == torch.float32
                assert idx3.shape == idx2.shape == (B, N, k) and idx3.dtype == idx2.dtype == torch.int32
                assert gy.shape == (B, M, C) and gy.dtype == torch.float32
                assert torch.isfinite(maxv).all() and torch.isfinite(gy).all()
                if not torch.equal(idx2, idx3):
                    raise AssertionError(f"K2 and K3 select differently at {B, N, M, C, k}")
                # K2's indices (and so K3's) against the plain version's
                other_set = sel.add(xn, yn, rel, k, idx2, knn_indices_reference(xn, yn, rel, k))
                want_max, _ = knn_max_idx_reference(xn, yn, yv, rel, k)
                # the same neighbours give the same max, bit for bit
                if ((maxv != want_max).any(-1) & ~other_set).any():
                    raise AssertionError(f"K3's max differs on an equal selection at {B, N, M, C, k}")
                err3 = max(err3, (maxv - want_max).abs().max().item())
                # K4 on K3's own indices: selection noise does not enter
                want_gy = knn_max_bwd_reference(yv, idx3, maxv, g, k)
                scale = knn_max_bwd_reference(yv, idx3, maxv, g.abs(), k)
                diff = (gy - want_gy).abs()
                tol = 1e-6 + 1e-5 * want_gy.abs() + 2e-6 * scale
                err4 = max(err4, diff.max().item())
                worst4 = max(worst4, (diff / tol).max().item())
                del want_max, want_gy, scale, diff, tol
            t_k3 = cuda_ms(lambda: knn_max_idx_cuda(xn, yn, yv, rel, k))
            t_k2 = cuda_ms(lambda: knn_indices_cuda(xn, yn, rel, k))
            t_k4 = cuda_ms(lambda: knn_max_bwd_cuda(yv, idx3, maxv, g, k))
            p_k3 = cuda_ms(lambda: knn_max_idx_reference(xn, yn, yv, rel, k))
            p_k2 = cuda_ms(lambda: knn_indices_reference(xn, yn, rel, k))
            p_k4 = cuda_ms(lambda: knn_max_bwd_reference(yv, idx3, maxv, g, k))
            flops = 2.0 * B * N * M * C
            b_k3, by3 = bound_ms(nbytes(xn, yn, yv, rel, maxv, idx3), flops)
            b_k2, by2 = bound_ms(nbytes(xn, yn, rel, idx2), flops)
            b_k4, by4 = bound_ms(nbytes(yv, idx3, maxv, g, gy), 2.0 * B * N * k * C)
            totals["knn_max_idx"][dtype].add(count, t_k3, p_k3, b_k3, by3, err3)
            totals["knn_max_bwd"][dtype].add(count, t_k4, p_k4, b_k4, by4, err4)
            print(
                f"train B={B} N={N} M={M} C={C} k={k} values {str(dtype)[6:]} x{count}: {sel}; "
                f"K3 {t_k3:.3f} ms plain {p_k3:.3f} bound {b_k3:.4f} ({by3}); "
                f"K2 {t_k2:.3f} ms plain {p_k2:.3f} bound {b_k2:.4f} ({by2}); "
                f"K4 {t_k4:.3f} ms plain {p_k4:.3f} bound {b_k4:.4f} ({by4}) "
                f"max|err| {err4:.3g} = {worst4:.3f} of tolerance"
            )
            sel.check("K2/K3", (B, N, M, C, k))
            if worst4 > 1.0:
                raise AssertionError(f"K4 disagrees with the plain version at {B, N, M, C, k}")
        torch.cuda.empty_cache()

    # K4 where every candidate receives one contribution: bit-exact, and the
    # same bits on a second launch
    (x, y, g), k = order_unambiguous_case(dev)
    xn, yn = l2_normalize(x).contiguous(), l2_normalize(y).contiguous()
    maxv, idx = knn_max_idx_cuda(xn, yn, y, None, k)
    assert idx.unique().numel() == idx.numel()
    gy = knn_max_bwd_cuda(y, idx, maxv, g, k)
    if not torch.equal(gy, knn_max_bwd_reference(y, idx, maxv, g, k)):
        raise AssertionError("K4 is not bit-exact where the add order cannot matter")
    if not torch.equal(gy, knn_max_bwd_cuda(y, idx, maxv, g, k)):
        raise AssertionError("K4 gave other bits on a second launch")
    # bf16 queries with f32 candidates: the f32 max is saved, so the
    # candidates' gradient is not lost
    yt = torch.randn(2, 150, 12, generator=gen, device=dev).requires_grad_()
    xt = torch.randn(2, 70, 12, generator=gen, device=dev).bfloat16()
    out = knn_max_neighbors(xt, 9, yt, None, train=True)
    out.float().sum().backward()
    assert out.dtype == torch.bfloat16 and yt.grad.dtype == torch.float32
    if not yt.grad.abs().sum() > 0:
        raise AssertionError("mixed bf16/f32: the candidates' gradient is zero")
    print("K4 bit-exact on the order-unambiguous case, the same bits twice; "
          "mixed bf16/f32 gradient non-zero")
    for name, by_dtype in totals.items():
        for dtype, t in by_dtype.items():
            print(f"{name} per flagship train step (values {str(dtype)[6:]}): {t.ms:.3f} ms, "
                  f"plain {t.plain_ms:.3f} ms, bound {t.bound_ms:.3f} ms")
    return {name: by_dtype[torch.bfloat16] for name, by_dtype in totals.items()}


def dilated_kernel_phase(spec, dev) -> Totals:
    """K2 at the shapes of the path that runs it: the dilated graphs of
    ``spec`` in a train step at batch 2, where it selects ``k * dilation``
    neighbours on f32 coordinates. Indices against the plain version's under
    the near-tie rule of :class:`Selection`; ``max_abs_err`` is the largest
    difference between the distances of K2's neighbours and the plain
    version's."""
    from nextou_tpu_torch.core.graph import l2_normalize
    from nextou_tpu_torch.core.pos_embed import relative_pos_bias
    from nextou_tpu_torch.kernels.knn import knn_indices_cuda, knn_indices_reference

    calls = knn_calls(spec, TRAIN_BATCH, dilated=True)
    assert calls, "the spec has no dilated graph"
    gen = torch.Generator(device=dev).manual_seed(11)
    total = Totals()
    for (B, N, M, C, k, self_graph), count in calls.items():
        rel = torch.tensor(relative_pos_bias(C, N, M, 3), device=dev).contiguous()
        sel = Selection()
        for _ in range(math.ceil(MIN_ROWS / (B * N))):
            xn = l2_normalize(torch.randn(B, N, C, generator=gen, device=dev)).contiguous()
            yn = xn if self_graph else l2_normalize(
                torch.randn(B, M, C, generator=gen, device=dev)).contiguous()
            idx = knn_indices_cuda(xn, yn, rel, k)
            assert idx.shape == (B, N, k) and idx.dtype == torch.int32
            sel.add(xn, yn, rel, k, idx, knn_indices_reference(xn, yn, rel, k))
        t_k2 = cuda_ms(lambda: knn_indices_cuda(xn, yn, rel, k))
        p_k2 = cuda_ms(lambda: knn_indices_reference(xn, yn, rel, k))
        bound, by = bound_ms(nbytes(xn, yn, rel, idx), 2.0 * B * N * M * C)
        total.add(count, t_k2, p_k2, bound, by, sel.dist_err)
        print(f"K2 B={B} N={N} M={M} C={C} k={k} x{count}: {sel}; "
              f"K2 {t_k2:.4f} ms plain {p_k2:.4f} bound {bound:.6f} ({by})")
        sel.check("K2", (B, N, M, C, k))
    print(f"knn_indices per train step of the small dilated network: {total.ms:.4f} ms, "
          f"plain {total.plain_ms:.4f} ms, bound {total.bound_ms:.6f} ms")
    return total


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


def train_phase(dev, spec) -> dict:
    """The training slice at full width and depth: 3 steps with Dice + CE, 2
    with the BTI Synapse term, one eval step."""
    from nextou_tpu_torch.kernels.knn import knn_max_bwd_cuda, knn_max_cuda, knn_max_idx_cuda
    from nextou_tpu_torch.losses import CompoundLossSpec, TILossSpec, deep_supervision_weights
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.models.nextou import remat_flags
    from nextou_tpu_torch.train import (
        create_train_state, make_eval_step, make_optimizer, make_train_step, poly_lr, pseudo_dice,
    )

    rng = np.random.default_rng(20)
    batch = {
        "data": rng.standard_normal((TRAIN_BATCH, *spec.patch_size, 1), dtype=np.float32),
        "seg": rng.integers(0, spec.num_classes, (TRAIN_BATCH, *spec.patch_size)),
    }
    model = NexToU(spec, dtype=torch.bfloat16, device=dev)
    opt = make_optimizer(poly_lr(1e-2, 1000, 0.9, steps_per_epoch=250))
    state = create_train_state(model, opt, seed=0)
    weights = deep_supervision_weights(len(spec.decoder))
    base = CompoundLossSpec()
    bti = CompoundLossSpec(weight_ti=1e-6, ti=TILossSpec.create(
        dim=3, connectivity=26, exclusion=BTI_SYNAPSE_EXCLUSION))
    graphers = [len(st.gnn) for st in (*spec.encoder, *spec.decoder)]
    recomputed = sum(n for n, again in zip(graphers, (*model.remat[0], *model.remat[1])) if again)
    assert sum(graphers) == 14

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers() if "running_" in n}
    for counter in (knn_max_idx_cuda, knn_max_bwd_cuda, knn_max_cuda):
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    seconds, plan = [], [("Dice+CE", base)] * 3 + [("Dice+CE+BTI", bti)] * 2
    steps = {name: make_train_step(model, opt, ls, weights) for name, ls in dict(plan).items()}
    for i, (name, _) in enumerate(plan):
        t0 = time.time()
        state, metrics = steps[name](state, batch)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        print(f"train step {i} ({name}): loss {loss:.4f} grad_norm {norm:.4f} "
              f"{seconds[-1]:.3f} s")
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"train step {i}: loss {loss}, grad_norm {norm}")
    peak = torch.cuda.max_memory_allocated(dev)
    k3, k4 = knn_max_idx_cuda.launches, knn_max_bwd_cuda.launches
    n_steps = len(plan)
    print(f"K3 launches {k3}, K4 launches {k4} in {n_steps} steps "
          f"({recomputed} of 14 graphers recomputed); K1 launches {knn_max_cuda.launches}; "
          f"peak device memory {peak / 2**30:.2f} GiB")
    if k3 != (14 + recomputed) * n_steps or k4 != 14 * n_steps or knn_max_cuda.launches:
        raise AssertionError(f"K3 launched {k3} times and K4 {k4} times in {n_steps} steps")
    assert state.step == n_steps

    # every parameter finite, and every one moved, but for the biases that
    # cannot: a conv or 1x1 bias directly under a normalization (its gradient
    # is zero up to rounding, and it starts at 0), and the bias of the
    # lowest-resolution head, whose loss weight is 0 (its kernel moves by the
    # weight decay alone). Norm scales and shifts, the transposed convs and
    # the other heads must all move.
    may_stay = re.compile(r"\.(conv|fc[12]\.0|nn\.0)\.bias$|^decoder\.seg_layers\.0\.bias$")
    unmoved = []
    for n, p in model.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"parameter {n} is not finite")
        if torch.equal(p, before[n]):
            unmoved.append(n)
    print(f"parameters: {len(before)} tensors finite, {len(unmoved)} unmoved: {unmoved[:5]}")
    if any(not may_stay.search(n) for n in unmoved):
        raise AssertionError(f"parameters that did not move: {unmoved[:5]}")
    still = [n for n, b in model.named_buffers() if n in stats and torch.equal(b, stats[n])]
    if still:
        raise AssertionError(f"BatchNorm statistics that did not move: {still[:5]}")
    del before, stats

    steady = seconds[1:3]
    print(f"seconds per step, batch {TRAIN_BATCH}, bf16: first {seconds[0]:.3f}; Dice+CE "
          f"{', '.join(f'{s:.3f}' for s in steady)} ({TRAIN_BATCH / min(steady):.3f} patches/s); "
          f"first with BTI {seconds[3]:.3f}, then {seconds[4]:.3f} "
          f"({TRAIN_BATCH / seconds[4]:.3f} patches/s)")

    knn_max_cuda.launches = 0
    out = make_eval_step(model, bti, weights)(state, batch)
    torch.cuda.synchronize()
    tp, fp, fn = (out[key].cpu() for key in ("tp", "fp", "fn"))
    seg = torch.from_numpy(batch["seg"])
    truth = torch.stack([(seg == c).sum() for c in range(1, spec.num_classes)])
    dice = pseudo_dice(tp, fp, fn)
    print(f"eval step: loss {out['loss'].item():.4f}, K1 launches {knn_max_cuda.launches}, "
          f"pseudo dice {[round(d, 4) for d in dice.tolist()]}")
    ok = (
        math.isfinite(out["loss"].item()) and knn_max_cuda.launches == 14
        and k3 == knn_max_idx_cuda.launches
        and all(t.dtype == torch.int64 and (t >= 0).all() for t in (tp, fp, fn))
        and torch.equal(tp + fn, truth) and (tp + fp).sum() <= seg.numel()
    )
    if not ok:
        raise AssertionError(f"eval step: tp {tp.tolist()} fp {fp.tolist()} fn {fn.tolist()}")

    # two more steps with every stage recomputed in the backward pass: K3
    # runs twice per grapher, K4 once
    model.remat = remat_flags(spec, True)
    for counter in (knn_max_idx_cuda, knn_max_bwd_cuda):
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    again_s = []
    for _ in range(2):
        t0 = time.time()
        state, metrics = steps["Dice+CE"](state, batch)
        torch.cuda.synchronize()
        again_s.append(time.time() - t0)
    loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
    print(f"train steps with every stage recomputed (Dice+CE): {again_s[0]:.3f} s, then "
          f"{again_s[1]:.3f} s; loss {loss:.4f} grad_norm {norm:.4f}; K3 launches "
          f"{knn_max_idx_cuda.launches}, K4 launches {knn_max_bwd_cuda.launches}; peak device "
          f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if not (math.isfinite(loss) and math.isfinite(norm)
            and (knn_max_idx_cuda.launches, knn_max_bwd_cuda.launches) == (2 * 28, 2 * 14)):
        raise AssertionError("the recomputed train steps failed their checks")
    return {"k3": k3, "k4": k4, "s_per_step": min(steady), "s_per_step_bti": seconds[4],
            "peak_bytes": peak}


def small_train_spec():
    """A five-stage network of about 2,000 kNN rows per forward whose
    bottleneck stage is dilated and stochastic: the one path that runs K2."""
    from nextou_tpu_torch.models.spec import build_model_spec

    spec = build_model_spec(
        in_channels=1, patch_size=(8, 16, 16), n_stages=5,
        features_per_stage=[6, 12, 12, 12, 12], kernel_sizes=[(3, 3, 3)] * 5,
        strides=[(1, 1, 1), (2, 2, 2), (2, 2, 2), (1, 1, 1), (1, 1, 1)],
        n_conv_per_stage=[2] * 5, n_conv_per_stage_decoder=[2] * 4,
        num_classes=3, deep_supervision=True,
    )
    enc = list(spec.encoder)
    enc[4] = dataclasses.replace(
        enc[4], gnn=tuple(dataclasses.replace(b, dilation=2) for b in enc[4].gnn))
    return dataclasses.replace(spec, encoder=tuple(enc), epsilon=0.5)


def small_train_phase(dev) -> int:
    """Two train steps of a small network in f32 on the card (K3 and K4, and
    K2 through one dilated, stochastic stage) against the same two steps on
    the CPU (plain versions, autograd's own backward).

    The network is small enough (about 2,000 kNN rows per forward) that a
    near tie is rare: a flipped row under batch statistics moves every
    gradient. Its gradient is sharp all the same (a norm above 100, and a
    relative 1e-6 in the parameters moves it by 1e-3), so two f32 runs part
    by percents in their second step: the card's state is set to the CPU's
    after each step, and every step starts from the same point on both.
    Tolerances per step: the loss within rtol 1e-4, the gradient norm within
    rtol 2e-2 and the update (parameters after minus before) within 10% of
    the CPU's in the L2 norm, each about six times what an H100 showed
    (3.2e-3 and 1.7e-2 in the first step, 5.5e-4 and 3.1e-3 in the second).
    A fault is far outside: halving the gradient that the neighbour max
    hands to the candidates moves this update by 119% of its norm, losing
    it by 141% (tried on the CPU with the plain version altered).
    Returns K2's launches on the card.
    """
    from nextou_tpu_torch.kernels.knn import knn_indices_cuda, knn_max_bwd_cuda, knn_max_idx_cuda
    from nextou_tpu_torch.losses import CompoundLossSpec, TILossSpec, deep_supervision_weights
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.train import create_train_state, make_optimizer, make_train_step

    spec = small_train_spec()
    rng = np.random.default_rng(30)
    batches = [
        {"data": rng.standard_normal((2, *spec.patch_size, 1), dtype=np.float32),
         "seg": rng.integers(0, 3, (2, *spec.patch_size))}
        for _ in range(2)
    ]
    loss_spec = CompoundLossSpec(weight_ti=1e-4, ti=TILossSpec.create(3, 26, [], [[1, 2]]))
    weights = deep_supervision_weights(len(spec.decoder))
    opt = make_optimizer(1e-2)

    def flat(model):
        return torch.cat([p.detach().cpu().flatten() for p in model.parameters()])

    states, steps = {}, {}
    for kind, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = NexToU(spec, device=d)
        states[kind] = create_train_state(model, opt, seed=4)
        steps[kind] = make_train_step(model, opt, loss_spec, weights)
    for counter in (knn_indices_cuda, knn_max_idx_cuda, knn_max_bwd_cuda):
        counter.launches = 0
    for i, batch in enumerate(batches):
        start = flat(states["cpu"].model)
        assert torch.equal(start, flat(states["cuda"].model))
        metrics = {}
        for kind in ("cuda", "cpu"):
            states[kind], m = steps[kind](states[kind], batch)
            metrics[kind] = m["loss"].item(), m["grad_norm"].item()
        (gl, gn), (wl, wn) = metrics["cuda"], metrics["cpu"]
        want = flat(states["cpu"].model) - start
        got = flat(states["cuda"].model) - start
        update_off = ((got - want).norm() / want.norm()).item()
        print(f"small network f32, train step {i}, card vs CPU: loss {gl:.6f} vs {wl:.6f}, "
              f"grad_norm {gn:.4f} vs {wn:.4f}, update off by {update_off:.2e} of its norm")
        if abs(gl - wl) > 1e-4 * abs(wl) or abs(gn - wn) > 2e-2 * abs(wn) or update_off > 0.1:
            raise AssertionError("the train step on the card disagrees with the CPU")
        states["cuda"].load_state_dict(states["cpu"].state_dict())
    k2, k3, k4 = (c.launches for c in (knn_indices_cuda, knn_max_idx_cuda, knn_max_bwd_cuda))
    print(f"small network launches in 2 steps: K2 {k2} K3 {k3} K4 {k4}")
    # 14 graphers, 2 of them dilated (K2 + plain gather and max), 12 fused
    if (k2, k3, k4) != (2 * 2, 12 * 2, 12 * 2):
        raise AssertionError(f"small train launches: K2 {k2} K3 {k3} K4 {k4}")
    return k2


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    from nextou_tpu_torch.kernels.knn import build_kernels
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
    logs = build_kernels()
    print(f"kernels built in {time.time() - t0:.1f} s from nextou_tpu_torch/csrc/ "
          f"(one nvcc -gencode arch=compute_90a,code=sm_90a per source, in parallel)")
    for lib, log in logs.items():
        used = [line for line in log.splitlines() if "Used" in line or "cached" in line]
        print(f"  {lib}: " + "; ".join(line.split("Used", 1)[-1].strip() for line in used))

    records = {"knn_max": kernel_phase(flagship_3d_spec(), dev)}
    records.update(train_kernel_phase(flagship_3d_spec(), dev))
    records["knn_indices"] = dilated_kernel_phase(small_train_spec(), dev)
    with tempfile.TemporaryDirectory() as tmp:
        # two cases of 64x280x240: 2 x 2 tiles of the 64x224x192 patch each
        sl = slice_phase(dev, tmp, flagship_3d_spec(num_classes=14), (64, 280, 240))
    small_reference_phase(dev)
    torch.cuda.empty_cache()
    tr = train_phase(dev, flagship_3d_spec(num_classes=14, deep_supervision=True))
    torch.cuda.empty_cache()
    k2_launches = small_train_phase(dev)

    # each kernel's numbers belong to the path that runs it ("path"): K1 to
    # predict.main on the flagship, K3 and K4 to the flagship's train steps,
    # K2 to the small dilated network's (no flagship graph is dilated)
    sources = {
        "knn_max": ("knn_max.cu", "nextou_tpu/kernels/knn.py:40", sl["launches"],
                    "flagship predict"),
        "knn_indices": ("knn_max_idx.cu", "nextou_tpu/kernels/knn.py:184", k2_launches,
                        "small dilated network, train steps"),
        "knn_max_idx": ("knn_max_idx.cu", "nextou_tpu/kernels/knn.py:278", tr["k3"],
                        "flagship train steps"),
        "knn_max_bwd": ("knn_max_bwd.cu", "nextou_tpu/kernels/knn.py:384", tr["k4"],
                        "flagship train steps"),
    }
    print(smi)
    print(json.dumps({"kernels": [
        {"name": kernel, "route": "cuda", "source": f"nextou_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches, **records[kernel].record(), "path": path}
        for kernel, (src, replaces, launches, path) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
