"""The card's peaks and the least time the kNN work of a forward or a train
step could take on it, from the network's spec and dtypes alone.

Peaks: NVIDIA H100 SXM5 80GB data sheet, dense: 3.35 TB/s of HBM3, 989
TFLOP/s bf16 on the tensor cores, 495 TFLOP/s TF32, 67 TFLOP/s f32 outside
the tensor cores. An f32-accurate product on the tensor cores (three TF32
products a term, the selection on f32 coordinates) runs at 495 / 3.

A kNN call ``(B, N, M, C, k)``: the bound is the larger of its bytes at
3.35 TB/s (each input read once, each output written once) and its
operations at the peak for its coordinates' dtype. Serving (K1): bf16
coordinates of the queries (and the candidates where they are not the
queries), the values in bf16, the f32 ``(N, M)`` bias read, the f32 max
written; ``2 B N M C`` operations at 989 TFLOP/s. Training: the forward (K3)
reads f32 coordinates, the bf16 values and the bias and writes the f32 max
and the int32 indices, ``2 B N M C`` at 165 TFLOP/s; the backward (K4) reads
the values, the indices, the max and the f32 cotangent and writes the f32
gradient, ``2 B N k C`` at 67 TFLOP/s.
"""

from __future__ import annotations

import math

PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_SPLIT_FLOPS = 495e12 / 3


def knn_calls(spec, batch: int) -> dict:
    """``(B, N, M, C, k, self_graph)`` -> calls per forward of ``batch``
    samples: one per grapher, a windowed grapher's windows batched."""
    calls: dict = {}
    for st in (*spec.encoder, *spec.decoder):
        for b in st.gnn:
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


def _bound_s(nbytes: float, ops: float, peak: float) -> float:
    return max(nbytes / PEAK_BYTES_S, ops / peak)


def knn_bound_ms(spec, batch: int, train: bool) -> float:
    """Least milliseconds of the kNN work of one forward (``train=False``)
    or one train step (``train=True``) of ``batch`` samples."""
    total = 0.0
    for (B, N, M, C, k, self_graph), count in knn_calls(spec, batch).items():
        ops = 2.0 * B * N * M * C
        cand = 0 if self_graph else B * M * C
        if train:
            k3 = (4 * (B * N * C + cand) + 2 * B * M * C + 4 * N * M
                  + 4 * B * N * C + 4 * B * N * k)
            k4 = 2 * B * M * C + 4 * B * N * k + 4 * B * N * C * 2 + 4 * B * M * C
            total += count * (_bound_s(k3, ops, PEAK_SPLIT_FLOPS)
                              + _bound_s(k4, 2.0 * B * N * k * C, PEAK_F32_FLOPS))
        else:
            k1 = 2 * (B * N * C + cand) + 2 * B * M * C + 4 * N * M + 4 * B * N * C
            total += count * _bound_s(k1, ops, PEAK_BF16_FLOPS)
    return total * 1e3
