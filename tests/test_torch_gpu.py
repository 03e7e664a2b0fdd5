"""The hand-written kernels K1-K5, T3 and the probes' (``nextou_tpu_torch/csrc/``)
against their plain PyTorch versions on a CUDA card. Imports no jax, so that it runs on a machine with the
card and without jax:

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
