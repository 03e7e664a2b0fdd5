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
   each step from the same state;
9. the conv kernel K5 against its plain version at the five flagship convs
   that ``conv_kernel="1"`` hands to it (the list is derived from the spec
   and must be e1a, e1b, e2a, d1a, d1b), in bf16 at batch 4 and in f32 at
   batch 1. Tolerance: f32 within 1e-4 (the order of an f32 sum of up to
   3,564 products); bf16 within one rounding of the output, 2^-7 of the
   value + 1e-3. Per shape its time beside ``F.conv3d``'s (cuDNN), the plain
   version's and its bound (bytes at 3.35 TB/s or 2 B S_out 27 C Co
   operations at the tensor cores' bf16 peak, for f32 the f32 peak);
10. serving with the kernel on: one flagship volume through
    ``predict.main --conv-kernel 1`` (K5 launched exactly 40 times, K1 112),
    seconds, peak device memory, labels in range; then a narrow network of
    the flagship's geometry (so that the same five convs reach K5), kernels
    halved as in phase 6, mode ``"1"`` against ``"0"`` on the card, in f32
    (K5's FMA kernel) and in bf16 (its tensor-core kernel): at most 0.1% of
    the logits outside atol 2e-3 / rtol 1e-3 in f32 (a kNN near tie may
    flip under the conv's reordered sum) and outside 5e-3 / 5e-3 in bf16
    (one rounding step of a conv output), argmax agreement 99.9%;
11. training with the kernel on: the flagship of phase 7 from the same seed
    takes 2 Dice + CE steps with ``conv_kernel="1"`` (K5 launched exactly 5
    times per step, its backward being the library conv's), the first loss
    within rtol 1e-2 of phase 7's first loss (bf16 compute: the conv's
    rounding differs, and kNN near ties with it), then one step with every
    stage recomputed (10 launches);
12. the tools: T4's ``check`` (K5 against the plain and the library conv at
    small cases), T2's row-patch probe in both output orders against its
    numpy oracle (max error under 1e-4), T1's dissection of K1 at its two
    shapes (mode ``full`` against the plain version, at most 0.1% of rows
    off; the five modes' times printed);
13. T3, the channels-last conv, through its tool: ``check`` and ``check3``
    (both entry points, ``pallas_conv`` and ``csub_conv``, in f32 and bf16,
    against the plain version and ``F.conv3d``; f32 within 1e-4 x max(1,
    |y|), bf16 within one rounding of the output, 2^-7 of the value +
    1e-3), then every case of the JAX tool's ``CASES`` in bf16 at full size
    beside ``F.conv3d`` on ``channels_last_3d`` tensors (TF32 off), the
    plain version and the bound;
14. the trainer: five labelled 1x64x280x240 cases with all 14 labels go
    through ``nextou_tpu_torch.run_training.main`` (``nnUNetTrainer_NexToU``,
    fold 0, 2 epochs of 4 iterations, 50 eval steps per epoch, then the
    final validation), and ``predict.main`` serves its
    ``checkpoint_final.pth``. K3 and K4 launched exactly 14 times per train
    step, K1 14 times per eval and per validation forward, K5 never; the
    remat choice logged with its estimate; losses finite; checkpoints,
    ``training_log.txt`` and ``validation/summary.json`` written; seconds
    per epoch and per iteration, the share of the train loop spent waiting
    in ``next(train_it)``, the host's cores and loader threads, peak device
    memory; then the host loader alone, seconds per augmented batch.

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
import sys
import tempfile
import time

import numpy as np
import torch

from nextou_tpu_torch.tools.timing import card, cuda_ms

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
        # stays None where no single PyTorch call computes the function (kNN
        # + gather + max, its indices, its backward)
        self.library_ms = None

    def add(self, count, ms, plain_ms, bound, by, err, library_ms=None):
        self.ms += count * ms
        self.plain_ms += count * plain_ms
        self.bound_ms += count * bound
        self.by[by] += count * bound
        self.max_abs_err = max(self.max_abs_err, err)
        if library_ms is not None:
            self.library_ms = (self.library_ms or 0.0) + count * library_ms

    def record(self) -> dict:
        return {"max_abs_err": self.max_abs_err, "ms": self.ms, "plain_ms": self.plain_ms,
                "bound_ms": self.bound_ms, "bound_by": max(self.by, key=self.by.get),
                "library_ms": self.library_ms}


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


def write_dataset(folder: str, spec, configuration: str, cases: int, shape, seed: int,
                  labelled: bool = False):
    """A preprocessed dataset folder (plans, dataset.json, cases) for ``spec``,
    in the plans format nnU-Net writes; each case is ``{case}.npz`` with
    ``data`` (C, *sp) f32 and ``seg`` (*sp) int16, the preprocessed layout.
    Without ``labelled`` the labels are all background and the data noise;
    with it every label is present (regions of a coarse random partition,
    16 x 40 x 40 voxels a cell) and the data is the label's intensity plus
    noise, saved with the foreground locations the sampler oversamples."""
    from nextou_tpu_torch.data.dataset import save_case

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
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(plans, f)
    labels = {"background": 0, **{f"organ{i}": i for i in range(1, spec.num_classes)}}
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump({"labels": labels, "numTraining": cases, "channel_names": {"0": "CT"},
                   "file_ending": ".nii.gz"}, f)
    rng = np.random.default_rng(seed)
    for i in range(cases):
        if not labelled:
            np.savez(os.path.join(folder, f"case_{i:03d}.npz"),
                     data=rng.standard_normal((1, *shape), dtype=np.float32),
                     seg=np.zeros(shape, np.int16))
            continue
        cell = (16, 40, 40)
        coarse = rng.standard_normal((spec.num_classes, *(-(-n // c) for n, c in zip(shape, cell))))
        seg = np.argmax(coarse, 0).astype(np.int16)
        for axis, c in enumerate(cell):
            seg = np.repeat(seg, c, axis=axis)
        seg = np.ascontiguousarray(seg[tuple(slice(0, n) for n in shape)])
        assert len(np.unique(seg)) == spec.num_classes, "a label is missing"
        data = (seg / (spec.num_classes - 1) - 0.5 + rng.normal(0, 0.3, shape)).astype(np.float32)
        save_case(folder, f"case_{i:03d}", data[None], seg)


def slice_phase(dev, tmp: str, spec, shape) -> dict:
    from nextou_tpu_torch import predict
    from nextou_tpu_torch.infer.sliding_window import compute_sliding_window_steps
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.kernels.knn import knn_max_cuda
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.utils import init_weights

    n_cases, config = 2, "3d_fullres_nextou"
    data_dir, model_dir, out_dir = (os.path.join(tmp, d) for d in ("data", "model", "out"))
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
    knn_max_cuda.launches = conv3d_cuda.launches = 0
    t0 = time.time()
    predict.main([model_dir, data_dir, config, "-tr", "nnUNetTrainer_NexToU",
                  "-o", out_dir, "--tile-batch", str(TILE_BATCH), "--device", str(dev)])
    torch.cuda.synchronize()
    main_s = time.time() - t0
    launches = knn_max_cuda.launches
    if conv3d_cuda.launches:
        raise AssertionError("the default configuration launched the conv kernel")
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
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
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
    for counter in (knn_max_idx_cuda, knn_max_bwd_cuda, knn_max_cuda, conv3d_cuda):
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    seconds, losses, plan = [], [], [("Dice+CE", base)] * 3 + [("Dice+CE+BTI", bti)] * 2
    steps = {name: make_train_step(model, opt, ls, weights) for name, ls in dict(plan).items()}
    for i, (name, _) in enumerate(plan):
        t0 = time.time()
        state, metrics = steps[name](state, batch)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        losses.append(loss)
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
    if conv3d_cuda.launches:
        raise AssertionError("the default configuration launched the conv kernel")
    return {"k3": k3, "k4": k4, "s_per_step": min(steady), "s_per_step_bti": seconds[4],
            "peak_bytes": peak, "first_loss": losses[0]}


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


def conv_calls(spec, mode: str = "1") -> list:
    """(name, C, Co, stride, input spatial) of the convs that ``conv_kernel``
    = ``mode`` hands to K5 in one forward, from the spec the way the model
    builds its stages: encoder stage ``s`` is ``e{s}``, the decoder stage at
    its resolution ``d{s}``, the convs of a stage ``a``, ``b``."""
    from nextou_tpu_torch.kernels.conv import conv_kernel_wins

    stages, shape, cin = [], tuple(spec.patch_size), spec.in_channels
    for i, st in enumerate(spec.encoder):
        stages.append((f"e{i}", st.n_conv, cin, st.features, st.kernel_size, st.stride, shape))
        shape = tuple(a // b for a, b in zip(shape, st.stride))
        cin = st.features
    ones = (1,) * spec.spatial_dims
    for i, st in enumerate(spec.decoder):
        s = len(spec.encoder) - 2 - i
        stages.append((f"d{s}", st.n_conv, 2 * st.features, st.features, st.kernel_size, ones,
                       tuple(spec.encoder[s].img_shape)))
    calls = []
    for name, n_conv, cin, cout, kernel, stride, shape in stages:
        for j in range(n_conv):
            strided = any(v > 1 for v in stride)
            named = mode == "1" or (mode == "s1" and not strided) or (mode == "s2" and strided)
            if named and len(kernel) == 3 and conv_kernel_wins(shape, cin, cout, kernel, stride):
                calls.append((name + "ab"[j], cin, cout, tuple(stride), shape))
            shape = tuple(a // b for a, b in zip(shape, stride))
            cin, stride = cout, ones
    return calls


# the narrow network with the conv kernel on against off, per compute dtype:
# atol, rtol, the share of logits allowed outside them, the least argmax
# agreement. f32: the order of an f32 sum, and the kNN near ties it flips
# (phase 6's rule; an H100 showed no difference at all: cuDNN's f32 conv adds
# in K5's order). bf16: a conv output that lands on the other side of a
# rounding step moves by 2^-8 of its value, and what follows moves with it:
# five times what an H100 showed (9.8e-4 at logits up to 0.28).
NARROW_TOLERANCES = {
    torch.float32: (2e-3, 1e-3, 1e-3, 0.999),
    torch.bfloat16: (5e-3, 5e-3, 1e-3, 0.999),
}

FLAGSHIP_CONVS = [
    ("e1a", 33, 66, (1, 2, 2), (64, 224, 192)), ("e1b", 66, 66, (1, 1, 1), (64, 112, 96)),
    ("e2a", 66, 132, (2, 2, 2), (64, 112, 96)), ("d1a", 132, 66, (1, 1, 1), (64, 112, 96)),
    ("d1b", 66, 66, (1, 1, 1), (64, 112, 96)),
]


def conv_kernel_phase(spec, dev) -> Totals:
    """K5 at the five flagship convs of its region: bf16 at the serving
    batch and f32 at batch 1 against the plain version; times by CUDA events
    beside ``F.conv3d``'s. Returns the bf16 sums: one serving forward's."""
    import torch.nn.functional as F

    from nextou_tpu_torch.kernels.conv import conv3d, conv3d_reference

    calls = conv_calls(spec)
    if calls != FLAGSHIP_CONVS:
        raise AssertionError(f"conv_kernel='1' routes {calls}")
    assert [c[0] for c in conv_calls(spec, "s1")] == ["e1b", "d1a", "d1b"]
    assert [c[0] for c in conv_calls(spec, "s2")] == ["e1a", "e2a"]
    gen = torch.Generator(device=dev).manual_seed(40)
    totals = {torch.bfloat16: Totals(), torch.float32: Totals()}
    for name, C, Co, stride, spatial in calls:
        for dtype, B in ((torch.bfloat16, TILE_BATCH * MIRRORS_PER_FORWARD), (torch.float32, 1)):
            x = torch.randn(B, C, *spatial, generator=gen, device=dev).to(dtype)
            w = (torch.randn(Co, C, 3, 3, 3, generator=gen, device=dev) * 0.05).to(dtype)
            got = conv3d(x, w, stride)
            torch.cuda.synchronize()
            want = conv3d_reference(x, w, stride)
            out_spatial = tuple(n // s for n, s in zip(spatial, stride))
            assert got.shape == want.shape == (B, Co, *out_spatial) and got.dtype == dtype
            assert torch.isfinite(got.float()).all()
            diff = (got.float() - want.float()).abs()
            err, differ = diff.max().item(), (diff > 0).float().mean().item()
            tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * want.float().abs() + 1e-3
            ok = bool((diff <= tol).all())
            del diff, want, tol
            t_k5 = cuda_ms(lambda: conv3d(x, w, stride), iters=3, warmup=1)
            t_lib = cuda_ms(lambda: F.conv3d(x, w, None, stride, 1))
            t_plain = cuda_ms(lambda: conv3d_reference(x, w, stride), iters=2, warmup=1)
            flops = 2.0 * B * math.prod(out_spatial) * 27 * C * Co
            peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
            bound, by = bound_ms(nbytes(x, w, got), flops, peak)
            totals[dtype].add(1, t_k5, t_plain, bound, by, err, t_lib)
            print(f"K5 {name} B={B} {C}->{Co} stride {stride} in {spatial} {str(dtype)[6:]}: "
                  f"max|err| {err:.3g} ({differ:.2e} of values differ)  K5 {t_k5:.3f} ms "
                  f"({flops / t_k5 / 1e9:.1f} TFLOP/s)  cudnn {t_lib:.3f} ms  plain {t_plain:.3f} ms  "
                  f"bound {bound:.4f} ms ({by})")
            if not ok:
                raise AssertionError(f"K5 disagrees with the plain version at {name} {dtype}")
            del x, w, got
        torch.cuda.empty_cache()
    for dtype, t in totals.items():
        print(f"K5 over the five convs ({str(dtype)[6:]}): {t.ms:.3f} ms, cudnn {t.library_ms:.3f} "
              f"ms, plain {t.plain_ms:.3f} ms, bound {t.bound_ms:.3f} ms")
    return totals[torch.bfloat16]


def narrow_flagship_spec():
    """The flagship's patch, kernels and strides at widths 6/12: its five
    convs of K5's region are in this network's too."""
    from nextou_tpu_torch.models.presets import flagship_3d_spec
    from nextou_tpu_torch.models.spec import build_model_spec

    flagship = flagship_3d_spec()
    return build_model_spec(
        in_channels=1, patch_size=flagship.patch_size, n_stages=6,
        features_per_stage=[6, 12, 12, 12, 12, 12],
        kernel_sizes=[st.kernel_size for st in flagship.encoder],
        strides=[st.stride for st in flagship.encoder],
        n_conv_per_stage=[2] * 6, n_conv_per_stage_decoder=[2] * 5,
        num_classes=3, deep_supervision=False,
    )


def conv_serving_phase(dev, tmp: str, spec, shape) -> dict:
    """One flagship volume through ``predict.main --conv-kernel 1``, on the
    dataset and checkpoint that :func:`slice_phase` left in ``tmp``; then a
    narrow network of the flagship's geometry with the kernel on against
    off, on the card in f32."""
    from nextou_tpu_torch import predict
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.kernels.knn import knn_max_cuda
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.utils import init_weights

    config = "3d_fullres_nextou"
    data_dir, model_dir, out_dir = (os.path.join(tmp, d) for d in ("data", "model", "out_k5"))
    forwards = 2 * (8 // MIRRORS_PER_FORWARD)  # 4 tiles at tile batch 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    conv3d_cuda.launches = knn_max_cuda.launches = 0
    t0 = time.time()
    predict.main([model_dir, data_dir, config, "-tr", "nnUNetTrainer_NexToU", "-o", out_dir,
                  "--cases", "case_000", "--tile-batch", str(TILE_BATCH), "--device", str(dev),
                  "--conv-kernel", "1"])
    torch.cuda.synchronize()
    main_s = time.time() - t0
    launches, k1 = conv3d_cuda.launches, knn_max_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev)
    with np.load(os.path.join(out_dir, "case_000.npz")) as z:
        seg = z["seg"]
    with np.load(os.path.join(tmp, "out", "case_000.npz")) as z:
        agree = float(np.mean(seg == z["seg"]))
    print(f"predict.main --conv-kernel 1: 1 volume {shape}, {forwards} forwards, {main_s:.2f} s "
          f"incl. model build and load; K5 launches {launches}, K1 launches {k1}; peak device "
          f"memory {peak / 2**30:.2f} GiB; labels {np.unique(seg).tolist()}; the same label as "
          f"without the kernel on {agree:.4f} of voxels")
    if (launches, k1) != (5 * forwards, 14 * forwards):
        raise AssertionError(f"K5 launched {launches} times, K1 {k1}, in {forwards} forwards")
    assert seg.shape == shape and seg.dtype == np.uint8 and seg.max() < spec.num_classes

    plans, _, infer_spec = predict.load_dataset(data_dir, config)
    checkpoint = os.path.join(model_dir, "checkpoint_final.pth")
    data = next(d for _, d in predict.iter_cases(data_dir, plans, config, ["case_000"]))
    times = {}
    for mode in ("1", "0"):
        model = predict.load_model(infer_spec, checkpoint, dev, conv_kernel=mode)
        seg_pred = predict.build_predictor(model, (0, 1, 2), tile_batch=TILE_BATCH, output="seg")
        torch.cuda.synchronize()
        t0 = time.time()
        seg_pred(data)
        torch.cuda.synchronize()
        times[mode] = time.time() - t0
        del model, seg_pred
    print(f"seconds per volume (8-way TTA, tile batch {TILE_BATCH}, bf16): {times['1']:.3f} with "
          f"conv_kernel='1', {times['0']:.3f} with '0' in the same run")

    # the f32 kernel, then the bf16 one, each in a network against the library conv
    narrow = narrow_flagship_spec()
    x = torch.from_numpy(np.random.default_rng(41).standard_normal(
        (2, *narrow.patch_size, 1)).astype(np.float32)).to(dev)
    for dtype, (atol, rtol, max_off, min_same) in NARROW_TOLERANCES.items():
        out = {}
        for mode in ("1", "0"):
            model = init_weights(
                NexToU(narrow, dtype=dtype, conv_kernel=mode, device=dev), seed=3).eval()
            conv3d_cuda.launches = 0
            with torch.no_grad():
                for p in model.parameters():
                    if p.dim() >= 2:
                        p.mul_(0.5)
                out[mode] = model(x).float().cpu().numpy()
            if conv3d_cuda.launches != (5 if mode == "1" else 0):
                raise AssertionError(
                    f"narrow network, mode {mode}: K5 launched {conv3d_cuda.launches} times")
        got, want = out["1"], out["0"]
        off = np.abs(got - want) > atol + rtol * np.abs(want)
        same = float(np.mean(np.argmax(got, -1) == np.argmax(want, -1)))
        print(f"narrow flagship-geometry network {str(dtype)[6:]}, conv_kernel '1' vs '0' on the "
              f"card: max|diff| {np.abs(got - want).max():.3g} (max|logit| {np.abs(want).max():.3g}), "
              f"{off.mean():.2e} of values outside atol {atol:g}/rtol {rtol:g}, argmax agreement "
              f"{same:.6f}")
        if off.mean() > max_off or same < min_same:
            raise AssertionError(f"the {dtype} network with the conv kernel on disagrees with it off")
    return {"launches": launches, "s_per_volume": times["1"], "s_per_volume_off": times["0"],
            "peak_bytes": peak}


def conv_train_phase(dev, spec, first_loss_off: float) -> dict:
    """The training slice with the conv kernel on: the flagship of
    :func:`train_phase` (the same seed and batch) with ``conv_kernel="1"``."""
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.losses import CompoundLossSpec, deep_supervision_weights
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.models.nextou import remat_flags
    from nextou_tpu_torch.train import create_train_state, make_optimizer, make_train_step, poly_lr

    rng = np.random.default_rng(20)
    batch = {
        "data": rng.standard_normal((TRAIN_BATCH, *spec.patch_size, 1), dtype=np.float32),
        "seg": rng.integers(0, spec.num_classes, (TRAIN_BATCH, *spec.patch_size)),
    }
    model = NexToU(spec, dtype=torch.bfloat16, conv_kernel="1", device=dev)
    opt = make_optimizer(poly_lr(1e-2, 1000, 0.9, steps_per_epoch=250))
    state = create_train_state(model, opt, seed=0)
    step = make_train_step(model, opt, CompoundLossSpec(), deep_supervision_weights(len(spec.decoder)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    seconds, losses, launches = [], [], []
    for i in range(3):
        if i == 2:  # every stage recomputed: each routed conv launches twice
            model.remat = remat_flags(spec, True)
        conv3d_cuda.launches = 0
        t0 = time.time()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        loss, norm = metrics["loss"].item(), metrics["grad_norm"].item()
        losses.append(loss)
        launches.append(conv3d_cuda.launches)
        print(f"train step {i} with conv_kernel='1'{' (every stage recomputed)' if i == 2 else ''}: "
              f"loss {loss:.4f} grad_norm {norm:.4f} {seconds[-1]:.3f} s, K5 launches {launches[-1]}")
        if not (math.isfinite(loss) and math.isfinite(norm)):
            raise AssertionError(f"train step {i} with the conv kernel: loss {loss}, grad_norm {norm}")
    peak = torch.cuda.max_memory_allocated(dev)
    off = abs(losses[0] - first_loss_off) / abs(first_loss_off)
    print(f"first loss {losses[0]:.6f} against {first_loss_off:.6f} with conv_kernel='0' from the "
          f"same state: off by {off:.2e}; peak device memory {peak / 2**30:.2f} GiB")
    if launches != [5, 5, 10] or off > 1e-2:
        raise AssertionError(f"train steps with the conv kernel: launches {launches}, loss off {off}")
    return {"launches": sum(launches[:2]), "s_per_step": seconds[1], "peak_bytes": peak}


def tools_phase(dev) -> dict:
    """T4's check, T2's probe and T1's dissection through the tools' own
    functions; returns the probes' records and launch counts."""
    import torch.nn.functional as F

    from nextou_tpu_torch.tools import exp_conv_probe, exp_conv_v2, exp_knn_dissect

    exp_conv_v2.check(dev)

    probe = Totals()
    exp_conv_probe.conv_probe_cuda.launches = 0
    TH, C, W, CO = (getattr(exp_conv_probe, n) for n in ("TH", "C", "W", "CO"))
    x, w = (torch.from_numpy(a).to(dev) for a in exp_conv_probe.probe_inputs())
    # the same function as one library call: a conv along the rows, k = 3
    x3, w3 = x.reshape(TH + 2, C, W).permute(2, 1, 0), w.reshape(3, C, CO).permute(2, 1, 0)
    want = exp_conv_probe.conv_probe_reference(x, w, True)
    assert (F.conv1d(x3, w3).permute(2, 1, 0) - want).abs().max() < exp_conv_probe.TOLERANCE
    t_lib = cuda_ms(lambda: F.conv1d(x3, w3), iters=20)
    moved = (x.numel() + w.numel() + TH * W * CO) * 4
    bound, by = bound_ms(moved, 2.0 * TH * W * 3 * C * CO)
    for transpose_out in (False, True):
        r = exp_conv_probe.run(dev, transpose_out)
        probe.add(1, r["ms"], r["plain_ms"], bound, by, r["err"], t_lib)
    print(f"conv_probe: library conv1d {t_lib:.4f} ms, bound {bound:.6f} ms ({by}) per output order")

    dissect = Totals()
    exp_knn_dissect.knn_dissect_cuda.launches = 0
    for tag, B, N, M, C, k in exp_knn_dissect.SHAPES:
        r = exp_knn_dissect.bench_shape(tag, B, N, M, C, k, dev)
        # f32 coordinates, bf16 values and the f32 bias in, the f32 max out
        moved = (B * N * C + B * M * C) * 4 + B * M * C * 2 + N * M * 4 + B * N * C * 4
        bound, by = bound_ms(moved, 2.0 * B * N * M * C)
        dissect.add(1, r["full"], r["plain_ms"], bound, by, r["max_abs_err"])
        print(f"knn_dissect {tag}: bound {bound:.4f} ms ({by})")
        torch.cuda.empty_cache()
    return {"conv_probe": probe, "knn_dissect": dissect,
            "probe_launches": exp_conv_probe.conv_probe_cuda.launches,
            "dissect_launches": exp_knn_dissect.knn_dissect_cuda.launches}


def conv_cl_phase(dev) -> tuple[Totals, int]:
    """T3 through the tool's own functions: ``check`` and ``check3`` (both
    entry points, f32 and bf16, against the plain version and the library
    conv), then every case of the JAX tool's ``CASES`` in bf16 at full size,
    timed beside ``F.conv3d`` on ``channels_last_3d`` tensors, the plain
    version and the bound (2 N S_out taps C Co operations at the bf16 tensor
    cores' peak, or the bytes). Returns the sums and the kernel's launches in
    the tool's run."""
    from nextou_tpu_torch.tools import exp_conv_kernel as t3

    t3.conv_cl_cuda.launches = 0
    t3.check(dev)
    t3.check3(dev)
    totals = Totals()
    for name, shape, co, kernel, stride in t3.CASES:
        r = t3.time_case(t3.pallas_conv, shape, co, kernel, stride, dev)
        bound, by = bound_ms(r["bytes"], r["flops"], PEAK_BF16_FLOPS)
        totals.add(1, r["ms"], r["plain_ms"], bound, by, r["max_abs_err"], r["library_ms"])
        print(f"conv_cl {name} {shape}->{co} k{kernel} s{stride} bf16: {r['ms']:.3f} ms "
              f"({r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s)  F.conv3d channels_last "
              f"{r['library_ms']:.3f} ms  plain {r['plain_ms']:.3f} ms  bound {bound:.4f} ms ({by})  "
              f"max|err| {r['max_abs_err']:.3g}")
    launches = t3.conv_cl_cuda.launches
    print(f"conv_cl over the {len(t3.CASES)} cases: {totals.ms:.3f} ms, F.conv3d "
          f"{totals.library_ms:.3f} ms, plain {totals.plain_ms:.3f} ms, bound "
          f"{totals.bound_ms:.3f} ms; {launches} launches in the tool's run")
    return totals, launches


# the trainer phase: 5 cases of 1x64x280x240, fold 0 (4 training cases, 1
# validation case), 2 epochs of 4 iterations at the reference's 50
# validation iterations per epoch
TRAIN_CASES, TRAIN_SHAPE, EPOCHS, ITERS = 5, (64, 280, 240), 2, 4
LOADER_BATCHES = 8


def trainer_phase(dev, tmp: str) -> dict:
    """The trainer at the flagship's full width through
    ``nextou_tpu_torch.run_training.main``, then ``predict.main`` on its
    ``checkpoint_final.pth``."""
    from nextou_tpu_torch import predict, run_training
    from nextou_tpu_torch.infer.sliding_window import compute_sliding_window_steps
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.kernels.knn import knn_max_bwd_cuda, knn_max_cuda, knn_max_idx_cuda
    from nextou_tpu_torch.models.presets import flagship_3d_spec

    config, spec = "3d_fullres_nextou", flagship_3d_spec(num_classes=14)
    data_dir = os.path.join(tmp, "train_data")
    t0 = time.time()
    write_dataset(data_dir, spec, config, TRAIN_CASES, TRAIN_SHAPE, seed=50, labelled=True)
    print(f"{TRAIN_CASES} labelled cases {TRAIN_SHAPE} written in {time.time() - t0:.1f} s")
    counters = (knn_max_cuda, knn_max_idx_cuda, knn_max_bwd_cuda, conv3d_cuda)
    for counter in counters:
        counter.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.time()
    trainer = run_training.main([data_dir, config, "0", "-tr", "nnUNetTrainer_NexToU",
                                 "--epochs", str(EPOCHS), "--iters", str(ITERS),
                                 "--device", str(dev)])
    torch.cuda.synchronize()
    main_s = time.time() - t0
    k1, k3, k4, k5 = (c.launches for c in counters)
    peak = torch.cuda.max_memory_allocated(dev)
    out = trainer.output_folder

    _, val = trainer.get_split()
    tiles = math.prod(len(s) for s in compute_sliding_window_steps(TRAIN_SHAPE, spec.patch_size))
    val_forwards = len(val.case_ids) * math.ceil(tiles / TILE_BATCH) * (8 // MIRRORS_PER_FORWARD)
    steps, evals = EPOCHS * ITERS, EPOCHS * trainer.num_val_iterations_per_epoch
    print(f"run_training.main: {EPOCHS} epochs x {ITERS} iterations, {evals} eval steps, "
          f"validation of {len(val.case_ids)} case(s) ({val_forwards} forwards): {main_s:.2f} s "
          f"incl. model build; remat {trainer.remat!r}; K3 {k3}, K4 {k4}, K1 {k1}, K5 {k5} "
          f"launches; peak device memory {peak / 2**30:.2f} GiB")
    if trainer.remat is not False:
        raise AssertionError(f"auto remat chose {trainer.remat!r} for the flagship at batch 2")
    if (k3, k4, k1, k5) != (14 * steps, 14 * steps, 14 * (evals + val_forwards), 0):
        raise AssertionError(f"trainer launches: K3 {k3} K4 {k4} K1 {k1} K5 {k5}")
    with open(os.path.join(out, "training_log.txt")) as f:
        log = f.read()
    remat_line = next((line for line in log.splitlines() if "auto remat:" in line), None)
    if remat_line is None or "activation estimate" not in remat_line:
        raise AssertionError("the trainer did not log its remat choice with its estimate")
    print(f"  {remat_line.split(' ', 2)[2]}")
    for e in trainer.log_history:
        per_iter = e["train_time_s"] / ITERS
        print(f"epoch {e['epoch']}: train_loss {e['train_loss']:.4f} val_loss {e['val_loss']:.4f} "
              f"ema {e['ema_pseudo_dice']:.4f}; {e['epoch_time_s']:.2f} s per epoch, train "
              f"{e['train_time_s']:.2f} s = {per_iter:.3f} s per iteration, waiting in "
              f"next(train_it) {e['loader_wait_s']:.2f} s = "
              f"{e['loader_wait_s'] / e['train_time_s']:.3f} of the train loop")
        if not (math.isfinite(e["train_loss"]) and math.isfinite(e["val_loss"])):
            raise AssertionError(f"epoch {e['epoch']}: a loss is not finite")
    print(f"host: os.cpu_count() {os.cpu_count()}, loader threads {trainer.loader_threads}")
    for name in ("checkpoint_final.pth", "checkpoint_best.pth", "training_log.txt",
                 "validation/summary.json"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"the trainer wrote no {name}")
    with open(os.path.join(out, "validation", "summary.json")) as f:
        summary = json.load(f)
    print(f"validation/summary.json: foreground mean Dice {summary['foreground_mean']['Dice']:.4f}")

    # predict.main serves the trainer's checkpoint_final.pth
    pred_dir = os.path.join(tmp, "train_pred")
    knn_max_cuda.launches = 0
    predict.main([out, data_dir, config, "-tr", "nnUNetTrainer_NexToU", "-o", pred_dir,
                  "--cases", *val.case_ids, "--tile-batch", str(TILE_BATCH), "--device", str(dev)])
    torch.cuda.synchronize()
    if knn_max_cuda.launches != 14 * val_forwards:
        raise AssertionError(f"predict.main launched K1 {knn_max_cuda.launches} times")
    for cid in val.case_ids:
        with np.load(os.path.join(pred_dir, f"{cid}.npz")) as z:
            seg = z["seg"]
        with np.load(os.path.join(out, "validation", f"{cid}.npz")) as z:
            agree = float(np.mean(seg == z["seg"]))
        print(f"predict.main on checkpoint_final.pth, {cid}: labels {np.unique(seg).tolist()}, "
              f"the trainer's validation label on {agree:.6f} of voxels")
        if seg.shape != TRAIN_SHAPE or seg.max() >= spec.num_classes or agree < 0.99:
            raise AssertionError(f"predict.main on the trained checkpoint: {cid}")

    # the host loader alone: seconds per augmented batch once its queue has
    # drained, beside the seconds per train step
    loader, _ = trainer.get_dataloaders()
    with loader:
        it = iter(loader)
        for _ in range(loader.prefetch + 1):
            next(it)
        t0 = time.perf_counter()
        for _ in range(LOADER_BATCHES):
            next(it)
        per_batch = (time.perf_counter() - t0) / LOADER_BATCHES
    print(f"host loader alone ({trainer.loader_threads} threads, {os.cpu_count()} cores): "
          f"{per_batch:.3f} s per augmented batch of {trainer.batch_size} over {LOADER_BATCHES} "
          f"batches")
    last = trainer.log_history[-1]
    return {"k1": k1, "k3": k3, "k4": k4, "s_per_iter": last["train_time_s"] / ITERS,
            "wait_share": last["loader_wait_s"] / last["train_time_s"], "peak_bytes": peak,
            "loader_s_per_batch": per_batch}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    from nextou_tpu_torch.kernels.build import build_kernels
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
    records["conv3d"] = conv_kernel_phase(flagship_3d_spec(), dev)
    with tempfile.TemporaryDirectory() as tmp:
        # two cases of 64x280x240: 2 x 2 tiles of the 64x224x192 patch each
        sl = slice_phase(dev, tmp, flagship_3d_spec(num_classes=14), (64, 280, 240))
        torch.cuda.empty_cache()
        sl5 = conv_serving_phase(dev, tmp, flagship_3d_spec(num_classes=14), (64, 280, 240))
    small_reference_phase(dev)
    torch.cuda.empty_cache()
    tr = train_phase(dev, flagship_3d_spec(num_classes=14, deep_supervision=True))
    torch.cuda.empty_cache()
    tr5 = conv_train_phase(dev, flagship_3d_spec(num_classes=14, deep_supervision=True),
                           tr["first_loss"])
    torch.cuda.empty_cache()
    k2_launches = small_train_phase(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        trained = trainer_phase(dev, tmp)
    torch.cuda.empty_cache()
    tools = tools_phase(dev)
    records["conv_probe"], records["knn_dissect"] = tools["conv_probe"], tools["knn_dissect"]
    records["conv_cl"], conv_cl_launches = conv_cl_phase(dev)

    # each kernel's numbers belong to the path that runs it ("path"): K1 to
    # predict.main on the flagship, K3 and K4 to the flagship's train steps,
    # K2 to the small dilated network's (no flagship graph is dilated), K5 to
    # the flagship with conv_kernel="1" (its launches: one served volume and
    # two train steps), the probes' kernels to their tools
    sources = {
        "knn_max": ("knn_max.cu", "nextou_tpu/kernels/knn.py:40", sl["launches"] + trained["k1"],
                    "flagship predict; the trainer's eval steps and validation"),
        "knn_indices": ("knn_max_idx.cu", "nextou_tpu/kernels/knn.py:184", k2_launches,
                        "small dilated network, train steps"),
        "knn_max_idx": ("knn_max_idx.cu", "nextou_tpu/kernels/knn.py:278", tr["k3"] + trained["k3"],
                        "flagship train steps; the trainer's"),
        "knn_max_bwd": ("knn_max_bwd.cu", "nextou_tpu/kernels/knn.py:384", tr["k4"] + trained["k4"],
                        "flagship train steps; the trainer's"),
        "conv3d": ("conv3d.cu", "nextou_tpu/kernels/conv.py:90",
                   sl5["launches"] + tr5["launches"],
                   "flagship predict and train steps with conv_kernel='1'"),
        "conv_probe": ("conv_probe.cu", "tools/exp_mosaic_probe.py:24", tools["probe_launches"],
                       "tools.exp_conv_probe, both output orders"),
        "knn_dissect": ("knn_dissect.cu", "tools/exp_knn_dissect.py:27", tools["dissect_launches"],
                        "tools.exp_knn_dissect, mode full at its two shapes"),
        "conv_cl": ("conv_cl.cu", "tools/exp_conv_kernel.py:37", conv_cl_launches,
                    "tools.exp_conv_kernel: check, check3 (csub_conv, kernel :359) and CASES"),
    }
    records = {kernel: totals.record() for kernel, totals in records.items()}
    records["conv3d"]["cudnn_ms"] = records["conv3d"]["library_ms"]
    print(smi)
    print(json.dumps({"kernels": [
        {"name": kernel, "route": "cuda", "source": f"nextou_tpu_torch/csrc/{src}",
         "replaces": replaces, "launches": launches, **records[kernel], "path": path}
        for kernel, (src, replaces, launches, path) in sources.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
