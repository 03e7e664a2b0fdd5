"""The f32-coordinate distance product of the kNN kernels K2 and K3 (and K1's
f32 instantiation), emulated in torch on the CPU.

``nextou_tpu_torch/csrc/knn_select.cuh`` multiplies f32 coordinates on the
tensor cores as 3xTF32: each value is split into ``hi = tf32(a)`` and
``lo = tf32(a - hi)`` (``cvt.rna``: 10 mantissa bits, round to nearest, ties
away from zero), and every k8 step of the product sums ``lo*hi + hi*lo + hi*hi`` and adds
that into one f32 accumulator. Here the same arithmetic, at the
flagship's widths, is held to an f64 computation and to the plain
version's selection; and one TF32 pass, the design the kernels refuse, is
shown to miss the 1e-5 that the split keeps.
"""

import numpy as np
import pytest
import torch

from nextou_tpu_torch.core.graph import knn_sq_dist, l2_normalize
from nextou_tpu_torch.kernels.knn import knn_indices_reference

KSTEP = 8  # channels per m16n8k8 step
TIE_GAP = 1e-4  # chip_smoke.py's near-tie bound


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 mantissa bits, rounding half away from
    zero. The float's magnitude bits are an integer, so adding half of the
    13 dropped bits and clearing them rounds the magnitude that way."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_dot(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a (N, C) . b (M, C)^T`` in f32 as the kernels take it: C padded with
    zeros to the k step, each step's ``lo*hi + hi*lo + hi*hi`` (``passes=3``)
    or ``hi*hi`` alone (``passes=1``, one TF32 pass) summed from zero and
    then added into one f32 sum. Products of two TF32 values are exact in
    f32."""
    pad = -a.shape[1] % KSTEP
    a, b = (torch.nn.functional.pad(t, (0, pad)) for t in (a, b))
    ahi, bhi = tf32_rna(a), tf32_rna(b)
    alo, blo = tf32_rna(a - ahi), tf32_rna(b - bhi)
    acc = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32)
    for c in range(0, a.shape[1], KSTEP):
        s = slice(c, c + KSTEP)
        step = ahi[:, s] @ bhi[:, s].T
        if passes == 3:
            step = (alo[:, s] @ bhi[:, s].T + ahi[:, s] @ blo[:, s].T) + step
        acc += step
    return acc


def f64_dist(x, y):
    """The same distances in f64 from the same f32 values."""
    x, y = x.double(), y.double()
    return ((x * x).sum(-1)[:, None] - 2.0 * x @ y.T) + (y * y).sum(-1)[None, :]


def emulated_dist(x, y, passes=3):
    """(x_sq - 2 <x, y>) + y_sq with f32 square sums, as the kernels form it."""
    xsq, ysq = (x * x).sum(-1), (y * y).sum(-1)
    return (xsq[:, None] - 2.0 * split_dot(x, y, passes)) + ysq[None, :]


def _coords(n, m, c, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, c)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((m, c)).astype(np.float32))
    return l2_normalize(x), l2_normalize(y)


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0**-10  # the TF32 step above 1
    vals = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-12])
    want = torch.tensor([one, -one, 1.0, one])
    assert torch.equal(tf32_rna(vals), want)
    x = torch.randn(1000)
    hi = tf32_rna(x)
    assert (hi.view(torch.int32) & 0x1FFF == 0).all()
    assert ((x - hi).abs() <= x.abs() * 2.0**-11).all()


@pytest.mark.parametrize("c", [132, 264, 324])
def test_split_product_keeps_f32_accuracy(c):
    x, y = _coords(300, 400, c, seed=c)
    want = f64_dist(x, y)
    got = emulated_dist(x, y)
    assert (got.double() - want).abs().max().item() <= 1e-5
    # one TF32 pass on the same inputs misses that bound
    one_pass = emulated_dist(x, y, passes=1)
    assert (one_pass.double() - want).abs().max().item() > 1e-5

    # the selection equals the plain version's but at near ties
    k = 28
    dist = knn_sq_dist(x[None], y[None])[0]
    got_idx = torch.sort(got, dim=-1, stable=True).indices[:, :k]
    want_idx = knn_indices_reference(x[None], y[None], None, k)[0].long()
    other = (got_idx.sort(-1).values != want_idx.sort(-1).values).any(-1)
    near = torch.sort(dist, dim=-1).values
    gaps = (near[:, k] - near[:, k - 1])[other]
    assert other.float().mean().item() <= 1e-2
    assert gaps.numel() == 0 or gaps.max().item() <= TIE_GAP
