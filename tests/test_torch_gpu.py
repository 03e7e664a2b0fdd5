"""The hand-written kernels K1-K5, T3 and the probes' (``nextou_tpu_torch/csrc/``)
against their plain PyTorch versions on a CUDA card; for the wgmma conv core
of K5 and T3 also its weight packing against the Python mirror (bit for bit)
and a one-hot (1, 1, 1) conv (exact). Imports no jax, so that it runs on a machine with the
card and without jax. Also holds the predictor's host-accumulation path
against its device path, and on-device augmentation against the CPU and the
host path, on the card:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Skips without a card. Also holds the seeded inputs that
``tests/test_torch_knn.py`` shares. "Tie-built" inputs have coordinates in
{0, +-1} with exactly four nonzeros per row: normalized, every entry is
+-0.5 and every distance an exact multiple of 1/2, in bf16 and f32 alike, so
the many equal distances are exactly equal whatever order a sum runs in.
"""

import numpy as np
import pytest
import torch

from nextou_tpu_torch.core.graph import dense_knn, dense_knn_reference, l2_normalize
from nextou_tpu_torch.kernels import knn as port_knn
from nextou_tpu_torch.kernels.knn import (
    knn_indices_cuda,
    knn_indices_reference,
    knn_max_bwd_cuda,
    knn_max_bwd_reference,
    knn_max_idx_cuda,
    knn_max_idx_reference,
    knn_max_neighbors,
    knn_max_neighbors_reference,
)


def _random(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tie_built(shape, seed):
    rng = np.random.default_rng(seed)
    *lead, c = shape
    out = np.zeros((int(np.prod(lead)), c), np.float32)
    for row in out:
        pos = rng.choice(c, 4, replace=False)
        row[pos] = rng.choice([-1.0, 1.0], 4)
    return out.reshape(shape)


def make_case(kind, self_graph, bias, n, m, c, seed, b=2):
    make = _random if kind == "random" else _tie_built
    x = make((b, n, c), seed)
    y = None if self_graph else make((b, m, c), seed + 1)
    rel = None
    if bias:
        cols = n if self_graph else m
        # multiples of 1/8: exact in f32, so tie-built distances stay tied
        rel = np.random.default_rng(seed + 2).integers(-4, 5, (n, cols)) / 8.0
        rel = rel.astype(np.float32)
    return x, y, rel


def hot_candidate_case(b, n, m, c, k, seed):
    """K4's inputs without a selection: every row names candidate 0 (at a
    random place among its k) and k - 1 other distinct candidates. Values
    are halves (exact in bf16), candidate 0 at 1.5 in every channel, so it
    holds or shares the max of most rows: its gradient is a walk over every
    row, with ties. Returns numpy ``yv (b, m, c)``, ``idx (b, n, k)`` int32
    and ``g (b, n, c)``; the max is the caller's, in its dtype."""
    rng = np.random.default_rng(seed)
    yv = (np.round(rng.standard_normal((b, m, c)) * 2) / 2).astype(np.float32)
    yv[:, 0] = 1.5
    start = rng.integers(0, m - 1, (b, n, 1))
    cols = np.concatenate(
        [np.zeros((b, n, 1), np.int64), 1 + (start + np.arange(k - 1)) % (m - 1)], axis=2)
    order = np.argsort(rng.random((b, n, k)), axis=2)
    idx = np.take_along_axis(cols, order, axis=2).astype(np.int32)
    g = rng.standard_normal((b, n, c)).astype(np.float32)
    return yv, idx, g


def selected_max(yv, idx):
    """The forward's f32 max over the selected candidates (torch tensors)."""
    from nextou_tpu_torch.core.graph import batched_index_select

    return batched_index_select(yv.float(), idx.long()).amax(2)


CASES = [
    # (self_graph, bias, n, m, c, k): unaligned N, self and cross, bias or not
    (True, False, 37, 37, 8, 5),
    (True, True, 40, 40, 12, 7),
    (False, False, 45, 16, 8, 4),
    (False, True, 70, 150, 12, 9),
]


# --- K1 on the card -------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain_on_gpu(dtype):
    if not torch.cuda.is_available():
        pytest.skip("K1 is CUDA code: needs a CUDA card")
    # the plain version's f32 product is full f32 (allow_tf32 defaults to False)
    dev = torch.device("cuda")
    for kind in ("random", "tie_built"):
        for self_graph, bias, n, m, c, k in CASES + [(False, True, 300, 1344, 264, 28)]:
            x, y, rel = make_case(kind, self_graph, bias, n, m, c, seed=n + c)
            args = [
                None if a is None else torch.from_numpy(a).to(dev)
                for a in (x, y, rel)
            ]
            xt = args[0].to(dtype)
            yt = None if args[1] is None else args[1].to(dtype)
            before = port_knn.knn_max_cuda.launches
            got = knn_max_neighbors(xt, k, yt, args[2])
            torch.cuda.synchronize()
            assert port_knn.knn_max_cuda.launches == before + 1
            want = knn_max_neighbors_reference(xt, k, yt, args[2]).to(dtype)
            assert got.dtype == dtype and got.shape == want.shape
            if kind == "tie_built":  # exact arithmetic: identical selections
                torch.testing.assert_close(got, want, rtol=0, atol=0)
            else:
                rows_off = (got != want).any(-1).float().mean().item()
                assert rows_off <= 1e-3, (kind, n, m, c, k, rows_off)
    with pytest.raises(NotImplementedError):
        knn_max_neighbors(xt, 33, yt, args[2])


# --- K2, K3 and K4 on the card ------------------------------------------------------


def _on(dev, *arrays):
    return [None if a is None else torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("values", [torch.float32, torch.bfloat16])
def test_k2_k3_k4_match_plain_on_gpu(values):
    if not torch.cuda.is_available():
        pytest.skip("K2, K3 and K4 are CUDA code: they need a CUDA card")
    dev = torch.device("cuda")
    for kind in ("random", "tie_built"):
        for self_graph, bias, n, m, c, k in CASES + [(False, True, 300, 1344, 264, 28)]:
            x, y, rel = make_case(kind, self_graph, bias, n, m, c, seed=n + c)
            x, y, rel = _on(dev, x, y, rel)
            xn = l2_normalize(x).contiguous()
            yn = xn if y is None else l2_normalize(y).contiguous()
            yv = (x if y is None else y).to(values).contiguous()
            g = torch.from_numpy(np.random.default_rng(n).standard_normal(x.shape)).float().to(dev)
            counts = [f.launches for f in (knn_indices_cuda, knn_max_idx_cuda, knn_max_bwd_cuda)]
            idx2 = knn_indices_cuda(xn, yn, rel, k)
            maxv, idx3 = knn_max_idx_cuda(xn, yn, yv, rel, k)
            gy = knn_max_bwd_cuda(yv, idx3, maxv, g, k)
            torch.cuda.synchronize()
            assert [f.launches for f in (knn_indices_cuda, knn_max_idx_cuda, knn_max_bwd_cuda)] == [
                v + 1 for v in counts]
            assert torch.equal(idx2, idx3)
            want_max, want_idx = knn_max_idx_reference(xn, yn, yv, rel, k)
            want_idx2 = knn_indices_reference(xn, yn, rel, k)
            if kind == "tie_built":  # exact arithmetic: the same neighbours, in order
                assert torch.equal(idx2, want_idx2)
                assert torch.equal(idx3, want_idx) and torch.equal(maxv, want_max)
            else:
                off2 = (idx2.sort(-1).values != want_idx2.sort(-1).values).any(-1)
                assert off2.float().mean().item() <= 1e-3, (n, m, c, k)
                off = (idx3.sort(-1).values != want_idx.sort(-1).values).any(-1)
                assert off.float().mean().item() <= 1e-3, (n, m, c, k)
                assert not ((maxv != want_max).any(-1) & ~off).any()
            # K4 on K3's own indices; f32 sums in another order than index_add_'s
            want_gy = knn_max_bwd_reference(yv, idx3, maxv, g, k)
            torch.testing.assert_close(gy, want_gy, rtol=1e-5, atol=1e-5)
            assert torch.equal(gy, knn_max_bwd_cuda(yv, idx3, maxv, g, k))  # deterministic
    with pytest.raises(ValueError):
        knn_indices_cuda(xn, yn, rel, 33)
    with pytest.raises(ValueError):
        knn_max_idx_cuda(xn.bfloat16(), yn, yv, rel, k)  # coordinates must be f32


def _k4_within_tolerance(gy, yv, idx, maxv, g, k):
    """chip_smoke.py phase 4's tolerance: 1e-6 + 1e-5 |want| + 2e-6 x the
    sum of the absolute contributions (f32 sums in another order)."""
    want = knn_max_bwd_reference(yv, idx, maxv, g, k)
    scale = knn_max_bwd_reference(yv, idx, maxv, g.abs(), k)
    tol = 1e-6 + 1e-5 * want.abs() + 2e-6 * scale
    assert ((gy - want).abs() <= tol).all(), (gy - want).abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("values", [torch.float32, torch.bfloat16])
def test_k4_hot_candidate_pool_and_windows_on_gpu(values):
    if not torch.cuda.is_available():
        pytest.skip("K4 is CUDA code: it needs a CUDA card")
    dev = torch.device("cuda")
    # one candidate in all 10,752 rows of each batch entry (s3 pool's M, C, k),
    # its rows in chunks whose partials are summed in chunk order
    yv, idx, g = _on(dev, *hot_candidate_case(2, 10752, 1344, 264, 28, seed=3))
    yv = yv.to(values)
    maxv = selected_max(yv, idx)
    assert port_knn.knn_max_bwd_plan(2, 10752, 1344, 264, 28, bf16=values == torch.bfloat16)[
        "chunks"] > 1
    gy = knn_max_bwd_cuda(yv, idx, maxv, g, 28)
    _k4_within_tolerance(gy, yv, idx, maxv, g, 28)
    assert torch.equal(gy, knn_max_bwd_cuda(yv, idx, maxv, g, 28))
    # s2 pool's shape and s3 swin's (one CTA per window and slice covers
    # every row), on K3's selection
    for b, n, m, c, k in ((2, 10752, 168, 132, 14), (128, 168, 168, 264, 14)):
        gen = torch.Generator(device=dev).manual_seed(n + c)
        x = torch.randn(b, n, c, generator=gen, device=dev)
        y = x if n == m else torch.randn(b, m, c, generator=gen, device=dev)
        xn = l2_normalize(x).contiguous()
        yn = xn if n == m else l2_normalize(y).contiguous()
        yv = y.to(values).contiguous()
        maxv, idx = knn_max_idx_cuda(xn, yn, yv, None, k)
        g = torch.randn(b, n, c, generator=gen, device=dev)
        gy = knn_max_bwd_cuda(yv, idx, maxv, g, k)
        _k4_within_tolerance(gy, yv, idx, maxv, g, k)
        assert torch.equal(gy, knn_max_bwd_cuda(yv, idx, maxv, g, k))
    plan = port_knn.knn_max_bwd_plan(128, 168, 168, 264, 14, bf16=values == torch.bfloat16)
    assert (plan["chunks"], plan["ranges"]) == (1, 1)
    # more candidates than one tile holds: ranges of candidates, each CTA
    # counting every row of its chunk
    yv, idx, g = _on(dev, *hot_candidate_case(1, 3000, 2000, 40, 9, seed=5))
    yv = yv.to(values)
    maxv = selected_max(yv, idx)
    assert port_knn.knn_max_bwd_plan(1, 3000, 2000, 40, 9, bf16=values == torch.bfloat16)[
        "ranges"] > 1
    gy = knn_max_bwd_cuda(yv, idx, maxv, g, 9)
    _k4_within_tolerance(gy, yv, idx, maxv, g, 9)
    assert torch.equal(gy, knn_max_bwd_cuda(yv, idx, maxv, g, 9))
    # windows where each candidate receives one contribution: no add order
    # can matter, so the bits are the plain version's
    rng = np.random.default_rng(4)
    b, n, k, c = 40, 168, 3, 264
    yv = torch.from_numpy(rng.standard_normal((b, n * k, c), dtype=np.float32)).to(dev)
    idx = torch.arange(n * k, dtype=torch.int32, device=dev).reshape(1, n, k).repeat(b, 1, 1)
    yv = yv.to(values)
    maxv = selected_max(yv, idx)
    g = torch.from_numpy(rng.standard_normal((b, n, c), dtype=np.float32)).to(dev)
    assert port_knn.knn_max_bwd_plan(b, n, n * k, c, k, bf16=values == torch.bfloat16)[
        "chunks"] == 1
    gy = knn_max_bwd_cuda(yv, idx, maxv, g, k)
    assert torch.equal(gy, knn_max_bwd_reference(yv, idx, maxv, g, k))
    assert torch.equal(gy, knn_max_bwd_cuda(yv, idx, maxv, g, k))


@pytest.mark.gpu
def test_train_dispatch_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("K2, K3 and K4 are CUDA code: they need a CUDA card")
    dev = torch.device("cuda")
    for self_graph, bias, n, m, c, k in CASES:
        x, y, rel = make_case("random", self_graph, bias, n, m, c, seed=2 * n + c)
        g = np.random.default_rng(n).standard_normal(x.shape).astype(np.float32)
        grads = {}
        for d in (dev, torch.device("cpu")):
            xt, yt, relt, gt = _on(d, x, y, rel, g)
            leaf = (xt if yt is None else yt).requires_grad_()
            before = port_knn.knn_max_idx_cuda.launches, port_knn.knn_max_bwd_cuda.launches
            out = knn_max_neighbors(xt, k, yt, relt, train=True)
            (out * gt).sum().backward()
            if d.type == "cuda":  # a tensor that needs a gradient goes to K3 and K4
                assert (port_knn.knn_max_idx_cuda.launches, port_knn.knn_max_bwd_cuda.launches) == (
                    before[0] + 1, before[1] + 1)
            grads[d.type] = out.detach().cpu(), leaf.grad.cpu()
        rows_off = (grads["cuda"][0] != grads["cpu"][0]).any(-1)
        assert rows_off.float().mean() <= 1e-3
        if not rows_off.any():  # the same selection: the same gradient up to add order
            torch.testing.assert_close(grads["cuda"][1], grads["cpu"][1], rtol=1e-5, atol=1e-5)
        # dense_knn on a CUDA tensor is K2
        x_dev, rel_dev = _on(dev, x, rel if self_graph else None)
        xn = l2_normalize(x_dev)
        before = knn_indices_cuda.launches
        idx = dense_knn(xn, k, relative_pos=rel_dev)
        assert knn_indices_cuda.launches == before + 1 and idx.dtype == torch.int64
        want = dense_knn_reference(xn, k, relative_pos=rel_dev)
        assert (idx.sort(-1).values != want.sort(-1).values).any(-1).float().mean() <= 1e-3
    with pytest.raises(NotImplementedError):
        dense_knn(xn, 33)


# --- the selection's plans, odd widths and duplicated rows ------------------------------

# (b, self_graph, n, m, c, k, plan): C off the k step (132, and the small
# network's 6 and 12), M off the 64-candidate chunk, and every plan the
# kernels take: 64, 32 or 16 query rows per CTA, or one CTA per window
SELECT_CASES = [
    (60, False, 300, 1000, 132, 28, (64, 0)),
    (30, False, 300, 1000, 132, 28, (32, 0)),
    (2, False, 300, 1000, 132, 28, (16, 0)),
    (3, True, 96, 96, 6, 5, (16, 0)),
    (2, False, 200, 150, 12, 9, (16, 0)),
    (136, True, 168, 168, 132, 7, (32, 1)),  # Swin windows, one CTA each
    (4, True, 168, 168, 324, 32, (16, 0)),  # s5: rows split finer
]


def _select_inputs(dev, kind, b, self_graph, n, m, c, seed):
    """Seeded features (and bias) on the card: ``random``, ``tie_built``,
    or ``duplicated``: random, the second half of the candidates repeating
    the first bit for bit (for a self-graph the queries with them), no
    bias."""
    if kind != "duplicated":
        return _on(dev, *make_case(kind, self_graph, True, n, m, c, seed, b=b))
    half_n = n // 2 if self_graph else n
    x, y, _ = make_case("random", self_graph, False, half_n, m // 2, c, seed, b=b)
    if self_graph:
        x = np.concatenate([x, x], axis=1)
    else:
        y = np.concatenate([y, y], axis=1)
    return _on(dev, x, y, np.zeros((n, n if self_graph else m), np.float32))


def _first_of_equal_rows(idx, half):
    """Whether every selected copy j >= half of candidate j - half comes
    after that candidate in its row: equal distances, lowest index first."""
    idx = idx.long().cpu()
    pos = torch.full((*idx.shape[:2], 2 * half), idx.shape[-1], dtype=torch.long)
    pos.scatter_(2, idx, torch.arange(idx.shape[-1]).expand_as(idx).contiguous())
    copies = pos[..., half:] < idx.shape[-1]
    return bool((pos[..., :half] < pos[..., half:])[copies].all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "tie_built", "duplicated"])
def test_selection_plans_widths_and_duplicates_on_gpu(kind):
    if not torch.cuda.is_available():
        pytest.skip("K1, K2 and K3 are CUDA code: they need a CUDA card")
    dev = torch.device("cuda")
    for i, (b, self_graph, n, m, c, k, plan) in enumerate(SELECT_CASES):
        x, y, rel = _select_inputs(dev, kind, b, self_graph, n, m, c, 40 + i)
        for bf16 in (True, False):
            got_plan = port_knn.kernel_plan(b, n, m, c, k, bf16=bf16, self_graph=self_graph)
            assert (got_plan["rows"], got_plan["window"]) == plan, (i, bf16, got_plan)
        # K1 in bf16 and in f32
        for dtype in (torch.bfloat16, torch.float32):
            xt, yt = x.to(dtype), None if y is None else y.to(dtype)
            got = knn_max_neighbors(xt, k, yt, rel)
            want = knn_max_neighbors_reference(xt, k, yt, rel).to(dtype)
            rows_off = (got != want).any(-1).float().mean().item()
            # tie-built: exact arithmetic, so the very same rows
            assert rows_off <= (0 if kind == "tie_built" else 1e-3), (i, dtype, rows_off)
        # K3 and K2 on f32 coordinates
        xn = l2_normalize(x).contiguous()
        yn = xn if y is None else l2_normalize(y).contiguous()
        yv = (x if y is None else y).bfloat16().contiguous()
        maxv, idx3 = knn_max_idx_cuda(xn, yn, yv, rel, k)
        idx2 = knn_indices_cuda(xn, yn, rel, k)
        torch.cuda.synchronize()
        assert torch.equal(idx2, idx3)
        want_max, want_idx = knn_max_idx_reference(xn, yn, yv, rel, k)
        off = (idx3.sort(-1).values != want_idx.sort(-1).values).any(-1)
        assert off.float().mean().item() <= 1e-3, (i, off.float().mean().item())
        assert not ((maxv != want_max).any(-1) & ~off).any()
        if kind == "tie_built":  # the same neighbours in the same order
            assert torch.equal(idx3, want_idx), i
        if kind == "duplicated":
            assert _first_of_equal_rows(idx3, m // 2), i
            if self_graph:  # a row's own distance and its copy's, bit-equal
                own = torch.arange(n, device=dev) % (n // 2)
                assert torch.equal(idx3[..., 0].long(), own.expand(b, n))
                assert torch.equal(idx3[..., 1].long(), (own + n // 2).expand(b, n))


@pytest.mark.gpu
def test_split_product_accuracy_through_t1_on_gpu():
    """T1's ``distonly`` and ``nosel`` write a row's least and k-th distance:
    the 3xTF32 product of f32 coordinates within 1e-5 of f64, streamed and
    in window mode."""
    if not torch.cuda.is_available():
        pytest.skip("T1's kernel is CUDA code: needs a CUDA card")
    from nextou_tpu_torch.tools import exp_knn_dissect

    dev = torch.device("cuda")
    k = 9
    for b, n, m, c, self_graph in ((2, 600, 1344, 324, False), (3, 700, 400, 132, False),
                                   (136, 168, 168, 264, True)):
        x, y, xn, yn, rel = exp_knn_dissect.dissect_inputs(b, n, m, c, dev)
        if self_graph:
            y, yn = x, xn
        x64, y64 = xn.double(), yn.double()
        dist = ((x64 * x64).sum(-1)[..., None] - 2.0 * x64 @ y64.transpose(1, 2)
                + (y64 * y64).sum(-1)[:, None, :] + rel.double()).sort(-1).values
        least = exp_knn_dissect.knn_dissect_cuda(xn, yn, y, rel, k, "distonly")[..., 0]
        kth = exp_knn_dissect.knn_dissect_cuda(xn, yn, y, rel, k, "nosel")[..., 0]
        assert (least.double() - dist[..., 0]).abs().max().item() <= 1e-5, (b, n, m, c)
        assert (kth.double() - dist[..., k - 1]).abs().max().item() <= 1e-5, (b, n, m, c)


# --- K5 and the tool probes on the card -----------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_matches_plain_on_gpu(dtype):
    if not torch.cuda.is_available():
        pytest.skip("K5 is CUDA code: needs a CUDA card")
    from nextou_tpu_torch.kernels.conv import conv3d, conv3d_cuda, conv3d_reference
    from nextou_tpu_torch.tools.exp_conv_v2 import CHECK_CASES, library_conv, seeded_case

    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    for B, spatial, C, Co, kernel, stride in CHECK_CASES:
        x, w = seeded_case(B, spatial, C, Co, kernel, dtype, dev)
        before = conv3d_cuda.launches
        got = conv3d(x, w, stride)
        torch.cuda.synchronize()
        assert conv3d_cuda.launches == before + 1
        want = conv3d_reference(x, w, stride)
        assert got.dtype == dtype and got.shape == want.shape
        # f32: the order of an f32 sum over at most 27 * 35 terms of size
        # <= 1; bf16: one rounding of the output (2^-8 relative) on top
        tol = dict(rtol=0, atol=1e-4) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(got, want, **tol)
        torch.testing.assert_close(got.float(), library_conv(x, w, stride).float(),
                                   rtol=tol["rtol"], atol=10 * tol["atol"])
    # the backward is the library conv's: the same gradients for the same
    # cotangent, up to the order in which cuDNN's backward kernels add (two
    # calls of one backward need not give the same bits)
    x, w = seeded_case(1, (4, 16, 40), 6, 5, (3, 3, 3), torch.float32, dev)
    x.requires_grad_(), w.requires_grad_()
    g = torch.randn(1, 5, 4, 8, 20, device=dev)
    got = torch.autograd.grad(conv3d(x, w, (1, 2, 2)), (x, w), g)
    want = torch.autograd.grad(library_conv(x, w, (1, 2, 2)), (x, w), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        conv3d(x, w.bfloat16(), (1, 1, 1))  # one dtype for both
    with pytest.raises(ValueError):
        conv3d(x, w, (3, 1, 1))


# --- the wgmma conv core that K5 and T3 share (csrc/conv_sm90.cuh) ----------------------

# (B, C, (D, H, W), Co, kernel, stride): Co = 33, 66, 132 and 324 (two N
# tiles), odd C, odd extents, Wo = 12, both strides; K5's routes "vec" (W % 8
# == 0) and "regs", T3's "regs" (odd C), "cp4" (even C) and "cp16" (C % 8 == 0)
SM90_CARD_CASES = [
    (2, 33, (5, 20, 48), 33, (3, 3, 3), (1, 1, 1)),
    (1, 66, (6, 18, 40), 66, (3, 3, 3), (1, 2, 2)),
    (1, 66, (7, 15, 45), 132, (3, 3, 3), (2, 2, 2)),
    (1, 648, (4, 14, 12), 324, (3, 3, 3), (1, 1, 1)),
    (2, 40, (3, 9, 24), 324, (3, 3, 3), (2, 2, 2)),
    (1, 33, (1, 16, 40), 33, (1, 3, 3), (1, 1, 1)),
    # a ring of two stages only with chunks of 8 at C <= 32 (32 -> 64, 24 ->
    # 132, 19 -> 11) or a block of 2 rows (66 -> 168 at column stride 2)
    (1, 32, (4, 16, 64), 64, (3, 3, 3), (2, 2, 2)),
    (1, 24, (3, 8, 40), 132, (3, 3, 3), (1, 1, 1)),
    (1, 66, (4, 8, 64), 168, (3, 3, 3), (2, 2, 2)),
    (1, 19, (6, 10, 66), 11, (3, 3, 3), (2, 2, 2)),
]


def _sm90_operands(B, C, spatial, Co, kernel, seed):
    """Seeded bf16 ``x (B, C, D, H, W)``, ``w (Co, C, *kernel)`` on the card,
    and their channels-last forms for T3."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(B, C, *spatial, generator=gen, device="cuda").bfloat16()
    w = (torch.randn(Co, C, *kernel, generator=gen, device="cuda") * 0.05).bfloat16()
    return x, w, x.permute(0, 2, 3, 4, 1).contiguous(), w.permute(2, 3, 4, 1, 0).contiguous()


@pytest.mark.gpu
def test_conv_sm90_weight_packing_is_the_python_mirror_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("the conv kernels are CUDA code: they need a CUDA card")
    from nextou_tpu_torch.kernels.build import library
    from nextou_tpu_torch.kernels.conv import conv_sm90_plan, library_plan, pack_weights_sm90

    stream = torch.cuda.current_stream().cuda_stream
    for i, (B, C, spatial, Co, kernel, stride) in enumerate(SM90_CARD_CASES):
        x, w, xl, wl = _sm90_operands(B, C, spatial, Co, kernel, i)
        taps = int(np.prod(kernel))
        for name, layout, args, py_args, wt, wd in (
            ("conv3d", "ncdhw", (B, C, *spatial, Co, *kernel, *stride),
             (B, C, spatial, Co, kernel, stride), w.reshape(Co, C, taps).permute(2, 1, 0), w),
            ("conv_cl", "ndhwc", (B, *spatial, C, Co, *kernel, *stride),
             (B, C, spatial, Co, kernel, stride), wl.reshape(taps, C, Co), wl),
        ):
            plan = library_plan(name, args)
            wp = torch.empty(plan["scratch"] // 2, dtype=torch.bfloat16, device="cuda")
            rc = getattr(library(name), f"{name}_pack_weights")(wd.data_ptr(), wp.data_ptr(), *args,
                                                               stream)
            torch.cuda.synchronize()
            assert rc == 0
            want = pack_weights_sm90(wt, conv_sm90_plan(layout, *py_args)).reshape(-1)
            assert torch.equal(wp.view(torch.int16), want.view(torch.int16)), (name, i)


@pytest.mark.gpu
def test_conv_sm90_plans_are_the_python_mirror_on_gpu():
    """The library's plan (conv3d_plan, conv_cl_plan) equals
    kernels/conv.py::conv_sm90_plan over a seeded sweep of shapes that the
    wrappers accept (x under 2^31 elements), and every shape has one."""
    if not torch.cuda.is_available():
        pytest.skip("the conv kernels are CUDA code: they need a CUDA card")
    from nextou_tpu_torch.kernels.conv import PLAN_KEYS, conv_sm90_plan, library_plan

    rng = np.random.default_rng(5)
    for _ in range(1000):
        B, C, Co = int(rng.integers(1, 5)), int(rng.integers(1, 700)), int(rng.integers(1, 400))
        if rng.random() < 0.5:
            C = int(rng.integers(1, 40))
        sp = tuple(int(v) for v in rng.integers(2, 97, 3))
        kernel = tuple(int(v) for v in rng.choice((1, 3), 3))
        stride = tuple(int(v) for v in rng.choice((1, 2), 3))
        for name, layout, args in (("conv3d", "ncdhw", (B, C, *sp, Co, *kernel, *stride)),
                                   ("conv_cl", "ndhwc", (B, *sp, C, Co, *kernel, *stride))):
            got = library_plan(name, args)
            want = conv_sm90_plan(layout, B, C, sp, Co, kernel, stride)
            assert all(got[k] == want[k] for k in PLAN_KEYS), (name, args, got, want)


@pytest.mark.gpu
def test_conv_sm90_one_hot_is_exact_on_gpu():
    """A (1, 1, 1) kernel is a plain GEMM: with output channel o copying input
    channel perm[o], every output is an input bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("the conv kernels are CUDA code: they need a CUDA card")
    from nextou_tpu_torch.kernels.conv import conv3d
    from nextou_tpu_torch.tools import exp_conv_kernel as t3

    for C, Co in ((16, 16), (33, 33), (66, 66), (24, 132), (40, 324)):
        x = torch.randn(1, C, 2, 8, 64, device="cuda").bfloat16()
        perm = torch.arange(Co, device="cuda") * 7 % C
        w = torch.zeros(Co, C, 1, 1, 1, device="cuda", dtype=torch.bfloat16)
        w[torch.arange(Co, device="cuda"), perm] = 1
        assert torch.equal(conv3d(x, w, (1, 1, 1)), x[:, perm]), (C, Co)
        xl, wl = x.permute(0, 2, 3, 4, 1).contiguous(), w.permute(2, 3, 4, 1, 0).contiguous()
        assert torch.equal(t3.conv_cl_cuda(xl, wl, (1, 1, 1)), xl[..., perm]), (C, Co)


@pytest.mark.gpu
def test_conv_sm90_widths_routes_and_strides_on_gpu():
    """K5 and T3 against their plain versions within one rounding of the
    output (2^-7 |y| + 1e-3, as chip_smoke.py's phase 9), at every width,
    route and stride of SM90_CARD_CASES."""
    if not torch.cuda.is_available():
        pytest.skip("the conv kernels are CUDA code: they need a CUDA card")
    from nextou_tpu_torch.kernels.conv import conv3d_cuda, conv3d_reference, library_plan
    from nextou_tpu_torch.tools import exp_conv_kernel as t3

    routes = {"conv3d": set(), "conv_cl": set()}
    for i, (B, C, spatial, Co, kernel, stride) in enumerate(SM90_CARD_CASES):
        x, w, xl, wl = _sm90_operands(B, C, spatial, Co, kernel, i)
        for name, got, want, args in (
            ("conv3d", conv3d_cuda(x, w, stride), conv3d_reference(x, w, stride),
             (B, C, *spatial, Co, *kernel, *stride)),
            ("conv_cl", t3.conv_cl_cuda(xl, wl, stride), t3.conv_cl_reference(xl, wl, stride),
             (B, *spatial, C, Co, *kernel, *stride)),
        ):
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == torch.bfloat16
            diff = (got.float() - want.float()).abs()
            assert bool((diff <= 2.0 ** -7 * want.float().abs() + 1e-3).all()), (name, i)
            routes[name].add(library_plan(name, args)["route"])
    assert routes == {"conv3d": {0, 3}, "conv_cl": {0, 1, 2}}


@pytest.mark.gpu
def test_tool_probes_match_their_oracles_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("the probes' kernels are CUDA code: they need a CUDA card")
    from nextou_tpu_torch.tools import exp_conv_probe, exp_knn_dissect

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for transpose_out in (False, True):
        assert exp_conv_probe.run(dev, transpose_out)["err"] < exp_conv_probe.TOLERANCE
    x, y, xn, yn, rel = exp_knn_dissect.dissect_inputs(3, 300, 1344, 40, dev)
    got = exp_knn_dissect.knn_dissect_cuda(xn, yn, y, rel, 9, "full")
    want = knn_max_neighbors_reference(x, 9, y, rel, train=True).float()
    assert (got != want).any(-1).float().mean().item() <= 1e-3
    for mode in ("nosel", "nominext", "distonly"):  # they launch; their outputs mean nothing
        out = exp_knn_dissect.knn_dissect_cuda(xn, yn, y, rel, 9, mode)
        assert out.shape == got.shape and torch.isfinite(out).all()


# --- T3, the channels-last conv ---------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_cl_matches_plain_on_gpu(dtype):
    if not torch.cuda.is_available():
        pytest.skip("T3's kernel is CUDA code: needs a CUDA card")
    from nextou_tpu_torch.tools import exp_conv_kernel as t3

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cases = [(t3.pallas_conv, c) for c in t3.small_cases() + t3.EXTRA_CHECK_CASES]
    cases += [(t3.csub_conv, c) for c in t3.check3_cases()]
    for i, (entry, (name, shape, co, kernel, stride)) in enumerate(cases):
        x, w = t3.seeded_case(shape, co, kernel, dtype, dev, seed=i)
        before = t3.conv_cl_cuda.launches
        got = entry(x, w, stride)
        torch.cuda.synchronize()
        assert t3.conv_cl_cuda.launches == before + 1, name
        for want in (t3.conv_cl_reference(x, w, stride), t3.xla_conv(x, w, stride)):
            ok, err, scale = t3.within_tolerance(got, want)
            assert ok, (entry.__name__, name, err, scale)
    with pytest.raises(ValueError):
        t3.conv_cl_cuda(x, w.float() if dtype == torch.bfloat16 else w.bfloat16(), (1, 1, 1))
    with pytest.raises(ValueError):
        t3.csub_conv(x, w, (2, 1, 1))


# --- the predictor's two accumulation paths ---------------------------------------------


@pytest.mark.gpu
def test_host_accumulation_matches_the_device_path_on_gpu(monkeypatch):
    """A small network (bf16 on the card, 8-way TTA, 2 x 2 tiles) predicted
    with its accumulators on the card and, above a patched budget, in host
    memory: every forward on the card in both (the same K1 launches), the
    probabilities within atol 1e-5 (the same forwards, f32 sums of the same
    terms on the card and on the host), the seg equal on 99.9% of voxels."""
    if not torch.cuda.is_available():
        pytest.skip("the predictor's forwards run K1, CUDA code: needs a CUDA card")
    from nextou_tpu_torch import predict
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.models.presets import small_3d_spec
    from nextou_tpu_torch.utils import init_weights

    dev = torch.device("cuda")
    spec = small_3d_spec(deep_supervision=False)
    model = init_weights(NexToU(spec, dtype=torch.bfloat16, device=dev), seed=6).eval()
    data = np.random.default_rng(6).standard_normal((16, 120, 100, 1)).astype(np.float32)
    out = {}
    for budget in (predict.ACC_BUDGET_BYTES, 1 << 20):
        monkeypatch.setattr(predict, "ACC_BUDGET_BYTES", budget)
        pred = predict.build_predictor(model, (0, 1, 2), tile_batch=2)
        before = port_knn.knn_max_cuda.launches
        probs = pred(data)
        out[pred.path] = probs, port_knn.knn_max_cuda.launches - before
    (dev_p, dev_k1), (host_p, host_k1) = (out[predict.DEVICE_ACCUMULATION],
                                          out[predict.HOST_ACCUMULATION])
    assert dev_k1 == host_k1 == 14 * 2 * 4  # 14 graphers, 2 tile batches, 4 mirror pairs
    assert host_p.shape == dev_p.shape == (*data.shape[:-1], spec.num_classes)
    np.testing.assert_allclose(host_p, dev_p, atol=1e-5, rtol=0)
    assert np.mean(np.argmax(host_p, -1) == np.argmax(dev_p, -1)) >= 0.999


# --- the plain and residual U-Nets, one input channel, the plain Grapher ---------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_one_input_channel_matches_plain_on_gpu(dtype):
    """K5 at C = 1 (a network's first conv on a one-channel image, padded to
    one chunk of 16 channels a tap), both strides, against the plain version
    (f32 within 1e-4, bf16 within one rounding of the output)."""
    if not torch.cuda.is_available():
        pytest.skip("K5 is CUDA code: needs a CUDA card")
    from nextou_tpu_torch.kernels.conv import conv3d, conv3d_cuda, conv3d_reference

    gen = torch.Generator(device="cuda").manual_seed(9)
    for B, spatial, Co, stride in ((2, (6, 12, 48), 32, (1, 1, 1)), (1, (5, 14, 34), 32, (2, 2, 2)),
                                   (1, (4, 8, 64), 64, (1, 2, 2))):
        x = torch.randn(B, 1, *spatial, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(Co, 1, 3, 3, 3, generator=gen, device="cuda") * 0.2).to(dtype)
        before = conv3d_cuda.launches
        got = conv3d(x, w, stride)
        torch.cuda.synchronize()
        assert conv3d_cuda.launches == before + 1
        want = conv3d_reference(x, w, stride)
        tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * want.float().abs() + 1e-3
        assert ((got.float() - want.float()).abs() <= tol).all(), (B, spatial, stride)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["plain", "residual"])
def test_plain_and_residual_unets_match_the_cpu_on_gpu(arch):
    """A narrow PlainConvUNet and ResidualEncoderUNet, f32 with the conv
    kernel on (K5 at their full-resolution (3, 3, 3) convs), on the card
    against the CPU (the plain conv): logits within atol 1e-3 / rtol 1e-3,
    in eval and in train mode."""
    if not torch.cuda.is_available():
        pytest.skip("K5 is CUDA code: needs a CUDA card")
    from nextou_tpu_torch.kernels.conv import conv3d_cuda
    from nextou_tpu_torch.models import (
        PlainConvUNet, ResidualEncoderUNet, build_plain_unet_spec,
        build_residual_encoder_unet_spec,
    )
    from nextou_tpu_torch.utils import init_weights

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(in_channels=1, patch_size=(64, 96, 112), n_stages=3, features_per_stage=[8, 16, 16],
              kernel_sizes=[[3, 3, 3]] * 3, strides=[[1, 1, 1], [2, 2, 2], [2, 2, 2]],
              n_conv_per_stage_decoder=[1, 1], num_classes=3, deep_supervision=False)
    if arch == "plain":
        spec, cls = build_plain_unet_spec(n_conv_per_stage=[2, 2, 2], **kw), PlainConvUNet
    else:
        spec, cls = build_residual_encoder_unet_spec(n_blocks_per_stage=[1, 2, 2], **kw), \
            ResidualEncoderUNet
    x = torch.from_numpy(_random((1, *spec.patch_size, 1), 3))
    cpu = init_weights(cls(spec), seed=1)
    card = cls(spec, conv_kernel="1", device="cuda")
    card.load_state_dict(cpu.state_dict())
    for mode in ("eval", "train"):
        before = conv3d_cuda.launches
        with torch.no_grad():
            want = getattr(cpu, mode)()(x)
            got = getattr(card, mode)()(x.cuda()).cpu()
        assert conv3d_cuda.launches > before
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
def test_grapher_matches_the_cpu_on_gpu():
    """The plain Grapher (K1 over the whole map, a reduced candidate set and
    a position bias) in f32 on the card against the CPU: within atol 2e-3 /
    rtol 1e-3 on all but 0.1% of values (kNN near ties)."""
    if not torch.cuda.is_available():
        pytest.skip("the Grapher's kNN runs K1, CUDA code: needs a CUDA card")
    from nextou_tpu_torch.core.pos_embed import relative_pos_bias
    from nextou_tpu_torch.nn.graphers import Grapher
    from nextou_tpu_torch.utils import init_weights

    C, sp, r = 24, (4, 8, 8), 2
    n, m = 256, 32
    x = torch.from_numpy(_random((2, *sp, C), 4))
    out = []
    for dev in ("cpu", "cuda"):
        table = torch.tensor(relative_pos_bias(C, n, m, 3), device=dev)[None]
        g = init_weights(Grapher(C, table, dims=3, k=9, reduce_ratio=r, groups=6,
                                 act_name="prelu", device=dev), seed=2)
        before = port_knn.knn_max_cuda.launches
        with torch.no_grad():
            out.append(g.eval()(x.to(dev)).cpu())
    assert port_knn.knn_max_cuda.launches == before + 1
    off = (out[1] - out[0]).abs() > 2e-3 + 1e-3 * out[0].abs()
    assert off.float().mean().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("dummy_2d", [False, True])
def test_device_augment_on_the_card_equals_the_cpu(dummy_2d):
    """``device_augment_batch`` on the card against the same plans on the
    CPU and against the host path (``augment_batch``) from the same seed,
    every transform firing: data within atol 1e-4 / rtol 1e-5, seg equal on
    99.99% of voxels. The plans are drawn once, on the host."""
    if not torch.cuda.is_available():
        pytest.skip("compares the card's augmentation with the CPU's: needs a CUDA card")
    from nextou_tpu_torch.data.augment import AugmentConfig, augment_batch, initial_patch_size
    from nextou_tpu_torch.data.device_augment import device_augment_batch, draw_augment_plan

    final = (16, 48, 40)
    rot = (np.pi,) * 3 if dummy_2d else (np.pi / 6,) * 3
    probs = {p: 1.0 for p in ("p_rotation", "p_scaling", "p_noise", "p_blur", "p_brightness",
                              "p_contrast", "p_lowres", "p_gamma_invert", "p_gamma")}
    cfg = AugmentConfig(**probs, rotation_rad=rot, dummy_2d=dummy_2d, mirror_axes=(0, 1, 2),
                        final_patch_size=final)
    initial = initial_patch_size(final, rot, dummy_2d)
    rng = np.random.default_rng(4)
    data = rng.standard_normal((2, 2, *initial)).astype(np.float32)
    seg = rng.integers(0, 14, (2, *initial)).astype(np.int16)
    want_d, want_s, _ = augment_batch(data.copy(), seg.copy(), cfg, np.random.default_rng(9))
    plan_rng = np.random.default_rng(9)
    plans = [draw_augment_plan(cfg, d.shape, plan_rng) for d in data]
    outs = {dev: device_augment_batch(torch.from_numpy(data).to(dev),
                                      torch.from_numpy(seg).to(dev), plans, cfg)
            for dev in ("cpu", "cuda")}
    assert outs["cuda"][0].is_cuda and outs["cuda"][0].shape == (2, 2, *final)
    for ref_d, ref_s in ((outs["cpu"][0].numpy(), outs["cpu"][1].numpy()), (want_d, want_s)):
        np.testing.assert_allclose(outs["cuda"][0].cpu().numpy(), ref_d, atol=1e-4, rtol=1e-5)
        assert (outs["cuda"][1].cpu().numpy() == ref_s).mean() >= 0.9999


# --- data parallel at one rank, --all-devices ------------------------------------------


def _batch_norm_on(dev, x, g):
    """A BatchNorm3d in training through the port's ``batch_norm``: output,
    gradients and running statistics."""
    from nextou_tpu_torch.nn.layers import batch_norm

    bn = torch.nn.BatchNorm3d(x.shape[1], device=dev).train()
    x = x.clone().requires_grad_()
    y = batch_norm(bn, x)
    (y.float() * g).sum().backward()
    return [y, x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean, bn.running_var]


@pytest.mark.gpu
def test_one_rank_batch_norm_is_the_fused_path_on_gpu(tmp_path, monkeypatch):
    """In a process group of one NCCL rank on the card, training-mode
    ``batch_norm`` (bf16 input) is the fused path of no group, bit for bit,
    and makes no all-reduce."""
    if not torch.cuda.is_available():
        pytest.skip("NCCL and the fused BatchNorm on the card: needs a CUDA card")
    import torch.distributed as dist

    from nextou_tpu_torch import parallel

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(5)
    x = (2 * torch.randn(2, 6, 8, 10, 12, generator=gen) + 1).to(dev, torch.bfloat16)
    g = torch.randn(2, 6, 8, 10, 12, generator=gen).to(dev)
    want = _batch_norm_on(dev, x, g)
    for name, value in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1").items():
        monkeypatch.setenv(name, value)
    assert parallel.initialize_distributed("cuda", f"file://{tmp_path}/store") == dev
    try:
        assert dist.get_backend() == "nccl" and parallel.world_size() == 1
        calls = parallel.all_reduce.calls
        got = _batch_norm_on(dev, x, g)
        assert parallel.all_reduce.calls == calls
    finally:
        dist.destroy_process_group()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_all_devices_equals_the_plain_predictor_on_gpu():
    """``build_predictor`` over ``local_devices`` (``predict --all-devices``)
    against the plain predictor, a small network in bf16 with 8-way TTA:
    bit for bit with one card; with more, each forward's tiles split over
    them, within phase 6's atol 2e-3 / rtol 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("the predictor's forwards run K1, CUDA code: needs a CUDA card")
    from nextou_tpu_torch import predict
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.models.presets import small_3d_spec
    from nextou_tpu_torch.parallel import local_devices
    from nextou_tpu_torch.utils import init_weights

    dev = torch.device("cuda", 0)
    spec = small_3d_spec(deep_supervision=False)
    model = init_weights(NexToU(spec, dtype=torch.bfloat16, device=dev), seed=6).eval()
    data = np.random.default_rng(6).standard_normal((16, 120, 100, 1)).astype(np.float32)
    devices = local_devices(dev)
    want = predict.build_predictor(model, (0, 1, 2), tile_batch=2)(data)
    got = predict.build_predictor(model, (0, 1, 2), tile_batch=2, devices=devices)(data)
    if len(devices) == 1:
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


@pytest.mark.gpu
def test_imported_upstream_checkpoint_serves_the_same_seg_on_gpu(tmp_path):
    """``chip_smoke.py`` phase 22 (f) at a small size: a run's weights
    rewritten in upstream's layout (``module.`` and ``_orig_mod.`` prefixes,
    ``current_epoch``), imported by ``import_torch_checkpoint`` on the card,
    serve through ``predict.main`` the seg of the run's own checkpoint, bit
    for bit."""
    if not torch.cuda.is_available():
        pytest.skip("the import builds the network on the card and predict runs K1: needs a "
                    "CUDA card")
    import json

    from nextou_tpu_torch import import_torch_checkpoint, predict
    from nextou_tpu_torch.models.presets import small_3d_spec
    from nextou_tpu_torch.tools.synthetic import write_dataset
    from nextou_tpu_torch.train import get_trainer_class

    config, folder, run = "3d_small", str(tmp_path / "data"), str(tmp_path / "run")
    write_dataset(folder, small_3d_spec(), config, 1, (16, 128, 112), seed=22, labelled=True)
    with open(f"{folder}/dataset.json") as f:
        dataset_json = json.load(f)
    trainer = get_trainer_class("nnUNetTrainer_NexToU")(
        f"{folder}/nnUNetPlans.json", config, 0, dataset_json, preprocessed_folder=folder,
        output_folder=run, device="cuda").initialize()
    weights = {k: v.cpu() for k, v in trainer.network.state_dict().items()}
    torch.save({"network_weights": weights}, f"{run}/checkpoint_final.pth")
    upstream = str(tmp_path / "upstream.pth")
    torch.save({"network_weights": {f"module._orig_mod.{k}": v for k, v in weights.items()},
                "current_epoch": 1}, upstream)
    imported = str(tmp_path / "imported")
    import_torch_checkpoint.main([upstream, folder, config, "-o", imported])
    segs = []
    for model in (run, imported):
        port_knn.knn_max_cuda.launches = 0
        predict.main([model, folder, config, "-o", f"{model}_pred"])
        assert port_knn.knn_max_cuda.launches > 0
        with np.load(f"{model}_pred/case_000.npz") as z:
            segs.append(z["seg"])
    assert segs[0].shape == (16, 128, 112)
    assert np.array_equal(*segs)
