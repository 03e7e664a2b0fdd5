"""The port's training kNN (plain versions of K2, K3 and K4, the ``train``
argument, the dilated graph) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed (``tests/test_torch_gpu.py``). The
Pallas kernels run in interpret mode, as ``tests/test_kernels.py`` runs them;
the gradient is held to ``jax.vjp`` of ``knn_max_neighbors_reference``, never
to a TPU kernel's output. The kernels themselves run only on the card: their
tests are in ``tests/test_torch_gpu.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextou_tpu.core.graph import _l2_normalize
from nextou_tpu.core.graph import dilated_knn_graph as jax_dilated_knn_graph
from nextou_tpu.kernels import knn as jax_knn
from nextou_tpu_torch.core.graph import dilated_knn_graph, knn_sq_dist, l2_normalize
from nextou_tpu_torch.kernels.knn import (
    knn_indices_reference,
    knn_max_bwd_reference,
    knn_max_idx_reference,
    knn_max_neighbors,
)
from tests.test_torch_gpu import CASES, hot_candidate_case, make_case, selected_max
from tests.test_torch_knn import emulate_k1_selection


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _normalized_pair(x, y):
    """The same normalized f32 coordinates for both packages."""
    xn = l2_normalize(_t(x))
    yn = xn if y is None else l2_normalize(_t(y))
    jxn = _l2_normalize(_j(x))
    jyn = jxn if y is None else _l2_normalize(_j(y))
    return xn, yn, jxn, jyn


# --- K2 and K3: the plain versions against the Pallas kernels ------------------


@pytest.mark.parametrize("kind", ["random", "tie_built"])
@pytest.mark.parametrize("self_graph,bias,n,m,c,k", CASES)
def test_k2_k3_plain_match_pallas_interpret(kind, self_graph, bias, n, m, c, k):
    x, y, rel = make_case(kind, self_graph, bias, n, m, c, seed=n + c)
    xn, yn, jxn, jyn = _normalized_pair(x, y)
    yv = x if y is None else y
    tile = min(256, -(-n // 8) * 8)
    want_idx = jax_knn._knn_indices_pallas(
        jxn, jyn, _j(rel), k=k, tile_n=tile, block_b=1, interpret=True
    )
    want_max, want_idx3 = jax_knn._knn_max_idx_pallas(
        jxn, jyn, _j(yv), _j(rel), k=k, tile_n=tile, block_b=1, interpret=True
    )
    got_idx = knn_indices_reference(xn, yn, _t(rel), k)
    got_max, got_idx3 = knn_max_idx_reference(xn, yn, _t(yv), _t(rel), k)
    assert got_idx.dtype == got_idx3.dtype == torch.int32
    assert got_max.dtype == torch.float32
    # bit-equal: the same neighbours in the same order (nearest first, ties to
    # the lowest index), and the same max
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_idx3.numpy(), np.asarray(want_idx3))
    np.testing.assert_array_equal(got_max.numpy(), np.asarray(want_max))


@pytest.mark.parametrize("self_graph,bias,n,m,c,k", CASES)
def test_train_forward_matches_pallas_train_mode_2(self_graph, bias, n, m, c, k, monkeypatch):
    # the JAX dispatcher reaching _knn_max_idx_pallas, as on the TPU
    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("NEXTOU_KNN_TRAIN_IDX", "2")
    x, y, rel = make_case("random", self_graph, bias, n, m, c, seed=n + c)
    want = jax_knn.knn_max_neighbors(_j(x), k, _j(y), _j(rel), train=True)
    got = knn_max_neighbors(_t(x), k, _t(y), _t(rel), train=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("self_graph,bias,n,m,c,k", CASES + [(False, True, 20, 200, 8, 32)])
def test_k3_selection_emulation_emits_indices_in_order_on_ties(self_graph, bias, n, m, c, k):
    # K3 writes lane j's entry of K1's running top-k as the j-th index: on
    # inputs built to tie, the emulated chunk logic gives the plain version's
    # indices in the plain version's order
    x, y, rel = make_case("tie_built", self_graph, bias, n, m, c, seed=11 + k)
    xn, yn, _, _ = _normalized_pair(x, y)
    dist = knn_sq_dist(xn, yn, _t(rel))
    idx = np.array([
        [emulate_k1_selection(row.tolist(), k) for row in graph] for graph in dist
    ])
    np.testing.assert_array_equal(idx, knn_indices_reference(xn, yn, _t(rel), k).numpy())


# --- K4: the plain version and autograd against jax.vjp --------------------------


def _jax_grads(x, y, rel, g, k):
    """Gradient of sum(out * g) with respect to x and y through the JAX
    reference in training mode (f32 selection)."""
    def loss(x_, y_):
        out = jax_knn.knn_max_neighbors_reference(x_, k, y_, _j(rel), train=True)
        return jnp.sum(out * _j(g))

    if y is None:
        return np.asarray(jax.grad(lambda x_: loss(x_, None))(_j(x))), None
    gx, gy = jax.grad(loss, argnums=(0, 1))(_j(x), _j(y))
    return np.asarray(gx), np.asarray(gy)


@pytest.mark.parametrize("self_graph,bias,n,m,c,k", [
    (True, True, 168, 168, 12, 7),
    (False, False, 336, 84, 12, 14),
    (False, True, 70, 150, 12, 9),
])
def test_backward_matches_jax_vjp(self_graph, bias, n, m, c, k):
    x, y, rel = make_case("random", self_graph, bias, n, m, c, seed=3 * n + c, b=3)
    g = np.random.default_rng(n).standard_normal(x.shape).astype(np.float32)
    want_gx, want_gy = _jax_grads(x, y, rel, g, k)

    # K4's plain version on K3's plain outputs
    xn, yn, _, _ = _normalized_pair(x, y)
    yv = _t(x if y is None else y)
    maxv, idx = knn_max_idx_reference(xn, yn, yv, _t(rel), k)
    gy = knn_max_bwd_reference(yv, idx, maxv, _t(g), k).numpy()
    # f32 sums in another order than XLA's scatter: rtol 1e-5 / atol 1e-6
    np.testing.assert_allclose(gy, want_gx if y is None else want_gy, rtol=1e-5, atol=1e-6)

    # autograd through the dispatcher: the selection carries no gradient
    xt = _t(x).requires_grad_()
    yt = None if y is None else _t(y).requires_grad_()
    out = knn_max_neighbors(xt, k, yt, _t(rel), train=True)
    (out * _t(g)).sum().backward()
    if y is None:
        np.testing.assert_allclose(xt.grad.numpy(), want_gx, rtol=1e-5, atol=1e-6)
    else:  # the queries only select: zero in JAX, no gradient at all here
        assert not np.any(want_gx) and xt.grad is None
        np.testing.assert_allclose(yt.grad.numpy(), want_gy, rtol=1e-5, atol=1e-6)


def order_unambiguous_case(seed=7, n=16, k=3, c=8):
    """N queries, each with k nearest candidates of its own, disjoint from
    every other query's (M = N * k clusters): each candidate receives exactly
    one contribution, so no add order can change the gradient."""
    rng = np.random.default_rng(seed)
    qs = rng.standard_normal((1, n, c)).astype(np.float32) * 10
    cands = np.repeat(qs[0], k, axis=0) + 0.01 * rng.standard_normal((n * k, c)).astype(np.float32)
    g = rng.standard_normal((1, n, c)).astype(np.float32)
    return qs, cands[None], g, k


def test_backward_bit_exact_where_order_cannot_matter():
    x, y, g, k = order_unambiguous_case()
    _, want = _jax_grads(x, y, None, g, k)
    xn, yn, _, _ = _normalized_pair(x, y)
    maxv, idx = knn_max_idx_reference(xn, yn, _t(y), None, k)
    assert len(np.unique(idx.numpy())) == idx.numel()  # a permutation
    np.testing.assert_array_equal(knn_max_bwd_reference(_t(y), idx, maxv, _t(g), k).numpy(), want)
    yt = _t(y).requires_grad_()
    (knn_max_neighbors(_t(x), k, yt, train=True) * _t(g)).sum().backward()
    np.testing.assert_array_equal(yt.grad.numpy(), want)


def test_mixed_dtype_gradient_is_not_zero():
    # x bf16 / y f32: the JAX package's train mode 2 saves the max cast to
    # bf16, which no f32 value equals again, and its y-gradient is zero. The
    # port keeps the f32 max.
    x, y, rel = make_case("random", False, True, 70, 150, 12, seed=5)
    g = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    yt = _t(y).requires_grad_()
    out = knn_max_neighbors(_t(x).bfloat16(), 9, yt, _t(rel), train=True)
    assert out.dtype == torch.bfloat16
    (out.float() * _t(g)).sum().backward()
    assert yt.grad.dtype == torch.float32 and yt.grad.abs().sum() > 0

    xn, yn, _, _ = _normalized_pair(x, y)
    maxv, idx = knn_max_idx_reference(xn, yn, _t(y), _t(rel), 9)
    kept = knn_max_bwd_reference(_t(y), idx, maxv, _t(g), 9)
    rounded = knn_max_bwd_reference(_t(y), idx, maxv.bfloat16().float(), _t(g), 9)
    assert kept.abs().sum() > 0
    assert rounded.abs().sum() < 0.05 * kept.abs().sum()  # the fault, reproduced


def emulate_k4(yv, idx, maxv, g, chunk_rows, width=32):
    """K4 in numpy, in the add order of ``nextou_tpu_torch/csrc/knn_max_bwd.cu``:
    per batch entry, slice of ``width`` channels and chunk of ``chunk_rows``
    query rows, an f32 tile from zero takes each row's share (``g / cnt``;
    ``g`` itself where one neighbour holds the max) at its tied candidates,
    rows ascending and a row's tied neighbours in ascending j; the chunks'
    partial tiles are then summed in chunk order. Indices outside [0, M)
    are dropped."""
    B, M, C = yv.shape
    N, k = idx.shape[1:]
    gy = np.zeros((B, M, C), np.float32)
    for b in range(B):
        for c0 in range(0, C, width):
            cs = slice(c0, c0 + width)
            parts = []
            for n0 in range(0, N, chunk_rows):
                tile = np.zeros_like(gy[b, :, cs])
                for n in range(n0, min(N, n0 + chunk_rows)):
                    keep = (idx[b, n] >= 0) & (idx[b, n] < M)
                    sel = yv[b, np.where(keep, idx[b, n], 0), cs]  # (k, width)
                    eq = (sel == maxv[b, n, cs]) & keep[:, None]
                    cnt = eq.sum(0).astype(np.float32)
                    share = np.where(cnt > 1, g[b, n, cs] / np.maximum(cnt, 1), g[b, n, cs])
                    for j in np.flatnonzero(keep):
                        m = idx[b, n, j]
                        tile[m] = np.where(eq[j], tile[m] + share, tile[m])
                parts.append(tile)
            acc = parts[0]
            for part in parts[1:]:
                acc = acc + part
            gy[b, :, cs] = acc
    return gy


def _selected_inputs(kind, b, n, m, c, k, seed):
    """K4's inputs on K3's plain selection (``random`` or ``tie_built``
    values), or without one (``hot``: :func:`hot_candidate_case`)."""
    if kind == "hot":
        yv, idx, g = hot_candidate_case(b, n, m, c, k, seed)
        return yv, idx, selected_max(_t(yv), _t(idx)).numpy(), g
    x, y, rel = make_case(kind, m == n, True, n, m, c, seed=seed, b=b)
    y = x if y is None else y
    g = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    xn, yn, _, _ = _normalized_pair(x, None if m == n else y)
    maxv, idx = knn_max_idx_reference(xn, yn, _t(y), _t(rel), k)
    return y, idx.numpy(), maxv.numpy(), g


@pytest.mark.parametrize("kind,b,n,m,c,k,chunk_rows", [
    pytest.param("random", 2, 70, 40, 12, 9, 32, id="random"),
    pytest.param("tie_built", 2, 70, 40, 12, 9, 32, id="tie_built"),
    # one candidate in every row: its walk is all of them
    pytest.param("hot", 1, 300, 40, 12, 5, 64, id="hot_candidate"),
    # 100 rows: a short last chunk; 40 channels: a slice of 32 and one of 8
    pytest.param("random", 2, 100, 30, 40, 6, 32, id="ragged_chunk"),
    # a window batch: one chunk covers each window
    pytest.param("tie_built", 6, 24, 24, 12, 5, 32, id="windows"),
])
def test_k4_two_pass_emulation_matches_plain(kind, b, n, m, c, k, chunk_rows):
    """The scatter pass by chunks of rows, then the sum of the partials."""
    # tie-built values make many equal maxima: the ties share the gradient
    yv, idx, maxv, g = _selected_inputs(kind, b, n, m, c, k, seed=9)
    want = knn_max_bwd_reference(_t(yv), _t(idx), _t(maxv), _t(g), k).numpy()
    got = emulate_k4(yv, idx, maxv, g, chunk_rows)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(emulate_k4(yv, idx, maxv, g, chunk_rows), got)
    ties = (yv[np.arange(b)[:, None, None], idx] == maxv[:, :, None]).sum(2)
    if kind == "tie_built":  # most maxima are shared by several neighbours
        assert (ties > 1).mean() > 0.5
    if kind == "hot":  # candidate 0 receives from most rows, ties among them
        assert (idx == 0).any(-1).all() and (ties > 1).any()
        assert (maxv == 1.5).mean() > 0.5
    if n <= chunk_rows:  # one chunk: the adds of a walk per candidate, ascending n
        np.testing.assert_array_equal(got, want)


# --- the dilated, stochastic graph -------------------------------------------------


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("self_graph,bias,n,m,c,k,dilation", [
    (True, True, 40, 40, 12, 4, 2),
    (False, False, 45, 30, 8, 3, 3),
])
def test_dilated_knn_graph_matches_jax(shuffle, self_graph, bias, n, m, c, k, dilation):
    x, y, rel = make_case("random", self_graph, bias, n, m, c, seed=n)
    # epsilon 1 or ~0 fixes the JAX gate; its permutation is read from its key
    eps = 1.0 if shuffle else 1e-9
    key = jax.random.PRNGKey(3)
    want = jax_dilated_knn_graph(
        _j(x), k, dilation, _j(y), _j(rel), stochastic=True, epsilon=eps, rng=key
    )
    _, k_perm = jax.random.split(key)
    cols = torch.from_numpy(np.array(jax.random.permutation(k_perm, k * dilation)[:k]))
    got = dilated_knn_graph(
        _t(x), k, dilation, _t(y), _t(rel), stochastic=True, epsilon=eps,
        shuffle=shuffle, perm_cols=cols,
    )
    assert got.shape == (2, n, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = dilated_knn_graph(_t(x), k, dilation, _t(y), _t(rel))
    np.testing.assert_array_equal(
        plain.numpy(), np.asarray(jax_dilated_knn_graph(_j(x), k, dilation, _j(y), _j(rel)))
    )


def test_dilated_knn_graph_draws_from_its_generator():
    x, _, _ = make_case("random", True, False, 40, 40, 12, seed=1)
    gen = torch.Generator().manual_seed(5)
    start = gen.get_state()
    a = dilated_knn_graph(_t(x), 4, 2, stochastic=True, epsilon=1.0, generator=gen)
    assert not torch.equal(gen.get_state(), start)
    gen.set_state(start)
    b = dilated_knn_graph(_t(x), 4, 2, stochastic=True, epsilon=1.0, generator=gen)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    full = dilated_knn_graph(_t(x), 8, 1)
    assert all(set(r.tolist()) <= set(f.tolist()) for r, f in zip(a[0], full[0]))
    with pytest.raises(ValueError):
        dilated_knn_graph(_t(x), 4, 2, stochastic=True, epsilon=0.5)
    # dilation 1: the branch is skipped and nothing is drawn
    state = gen.get_state()
    dilated_knn_graph(_t(x), 4, 1, stochastic=True, epsilon=1.0, generator=gen)
    assert torch.equal(gen.get_state(), state)
