"""The port's kNN + neighbour-max (plain version, dispatcher, K1's selection
logic) against the JAX package's, on the CPU; K1 itself on the card.

Inputs are made with numpy from a seed (``tests/test_torch_gpu.py``, whose
"tie-built" inputs make many exactly equal distances). K1's own test on the
card is in that jax-free file, so that it runs where jax is not installed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextou_tpu.core.graph import _l2_normalize
from nextou_tpu.core.graph import dense_knn as jax_dense_knn
from nextou_tpu.kernels import knn as jax_knn
from nextou_tpu_torch.core.graph import dense_knn, knn_sq_dist, l2_normalize
from nextou_tpu_torch.kernels import knn as port_knn
from nextou_tpu_torch.kernels.knn import (
    knn_max_neighbors,
    knn_max_neighbors_reference,
)
from tests.test_torch_gpu import CASES, make_case as _case


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("kind", ["random", "tie_built"])
@pytest.mark.parametrize("self_graph,bias,n,m,c,k", CASES)
def test_plain_matches_jax_reference(kind, self_graph, bias, n, m, c, k):
    x, y, rel = _case(kind, self_graph, bias, n, m, c, seed=n + c)
    want = jax_knn.knn_max_neighbors_reference(_j(x), k, _j(y), _j(rel))
    got = knn_max_neighbors_reference(_t(x), k, _t(y), _t(rel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    # the selections themselves: identical indices, ties to the lowest index
    xn = l2_normalize(_t(x))
    yn = None if y is None else l2_normalize(_t(y))
    jxn = _l2_normalize(_j(x))
    jyn = None if y is None else _l2_normalize(_j(y))
    idx = dense_knn(xn, k, yn, _t(rel)).numpy()
    np.testing.assert_array_equal(idx, np.asarray(jax_dense_knn(jxn, k, jyn, _j(rel))))
    dist = knn_sq_dist(xn, yn, _t(rel)).numpy()
    lex = np.stack([
        np.lexsort((np.arange(dist.shape[-1]), row))[:k]
        for row in dist.reshape(-1, dist.shape[-1])
    ])
    np.testing.assert_array_equal(idx.reshape(-1, k), lex)


def test_tie_built_inputs_really_tie():
    x, y, _ = _case("tie_built", False, False, 70, 150, 12, seed=1)
    dist = knn_sq_dist(l2_normalize(_t(x)), l2_normalize(_t(y))).numpy()
    assert np.all(dist * 2 == np.round(dist * 2))  # exact multiples of 1/2
    kth = np.sort(dist, axis=-1)[..., 8:10]  # k = 9: the 9th and 10th nearest
    assert np.mean(kth[..., 0] == kth[..., 1]) > 0.5


@pytest.mark.parametrize("kind", ["random", "tie_built"])
@pytest.mark.parametrize("self_graph,bias,n,m,c,k", CASES)
def test_pallas_interpret_matches_port(kind, self_graph, bias, n, m, c, k, monkeypatch):
    # run the Pallas kernel itself (interpret mode), as tests/test_kernels.py does
    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "1")
    x, y, rel = _case(kind, self_graph, bias, n, m, c, seed=n + c)
    want = jax_knn.knn_max_neighbors(_j(x), k, _j(y), _j(rel))
    got = knn_max_neighbors(_t(x), k, _t(y), _t(rel))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_dispatcher_sends_cpu_tensors_to_plain(monkeypatch):
    def no_kernel(*args, **kwargs):
        raise AssertionError("a CPU tensor reached K1")

    monkeypatch.setattr(port_knn, "knn_max_cuda", no_kernel)
    x, y, rel = _case("random", False, True, 30, 20, 8, seed=4)
    got = knn_max_neighbors(_t(x).double(), 5, _t(y).double(), _t(rel))
    want = knn_max_neighbors_reference(_t(x).double(), 5, _t(y).double(), _t(rel))
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- K1's selection, emulated -------------------------------------------------
# Same chunking as nextou_tpu_torch/csrc/knn_select.cuh: candidates in chunks of
# TM = 64, offered 32 at a time (one per lane); lanes that beat the current
# k-th are inserted lowest lane first, each after every entry not farther,
# and the rest are re-filtered against the new k-th.

TM, LANES = 64, 32


def emulate_k1_selection(dist_row, k):
    topd, topi = [float("inf")] * LANES, [0] * LANES
    m_total = len(dist_row)
    for m0 in range(0, m_total, TM):
        for g in range(0, TM, LANES):
            dl = [
                dist_row[m0 + g + l] if m0 + g + l < m_total else float("inf")
                for l in range(LANES)
            ]
            passing = [l for l in range(LANES) if dl[l] < topd[k - 1]]
            while passing:
                src, passing = passing[0], passing[1:]
                d = dl[src]
                pos = sum(1 for j in range(k) if topd[j] <= d)
                topd = topd[:pos] + [d] + topd[pos:-1]
                topi = topi[:pos] + [m0 + g + src] + topi[pos:-1]
                passing = [l for l in passing if dl[l] < topd[k - 1]]
    return topi[:k]


@pytest.mark.parametrize("self_graph,bias,n,m,c,k", CASES + [(False, True, 20, 200, 8, 32)])
def test_k1_selection_emulation_matches_plain_on_ties(self_graph, bias, n, m, c, k):
    x, y, rel = _case("tie_built", self_graph, bias, n, m, c, seed=7 + k)
    xn = l2_normalize(_t(x))
    yn = None if y is None else l2_normalize(_t(y))
    dist = knn_sq_dist(xn, yn, _t(rel))
    idx = torch.tensor([
        [emulate_k1_selection(row.tolist(), k) for row in graph] for graph in dist
    ])
    np.testing.assert_array_equal(idx.numpy(), dense_knn(xn, k, yn, _t(rel)).numpy())
