"""The port's layers, conv blocks, graph-conv pieces and graphers against the
JAX package's modules, on the CPU, in f32.

Each JAX module is initialized with ``fast_init`` and randomized from a
numpy seed; its variables reach the port module through the block helpers
of ``nextou_tpu_torch.compat.weights`` (the pieces of
``variables_to_state_dict``). The JAX graphers' kNN runs through its plain
reference path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextou_tpu.core import window as jax_window
from nextou_tpu.nn import conv_blocks as jax_blocks
from nextou_tpu.nn import graph_conv as jax_gc
from nextou_tpu.nn import graphers as jax_graphers
from nextou_tpu.utils import fast_init
from nextou_tpu_torch.compat.weights import (
    conv_blocks_state,
    ffn_state,
    grapher_state,
)
from nextou_tpu_torch.core.pos_embed import relative_pos_bias
from nextou_tpu_torch.core.window import window_partition, window_reverse
from nextou_tpu_torch.nn.conv_blocks import StackedConvBlocks
from nextou_tpu_torch.nn.graph_conv import (
    avg_pool,
    max_pool_with_argmax,
    max_unpool_scatter,
)
from nextou_tpu_torch.nn.graphers import FFN, PoolGrapher, SwinGrapher
from tests.test_torch_model import randomized

# f32 on both sides, sums in another order (oneDNN/MKL vs XLA)
TOL = dict(rtol=1e-4, atol=1e-4)
C = 12  # divisible by the 3D group count (6) and the sin-cos embedding (6)


@pytest.fixture(autouse=True)
def jax_knn_plain(monkeypatch):
    # tests/test_kernels.py turns the Pallas interpreter on process-wide
    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "0")


def _x(shape, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:  # small integers: plenty of exact ties in every window
        return rng.integers(-2, 3, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


def _jax_apply(module, x, seed):
    variables = randomized(fast_init(module, seed, jnp.asarray(x), train=False), seed)
    return variables, np.asarray(module.apply(variables, jnp.asarray(x), train=False))


def _port(module, state):
    missing, unexpected = module.load_state_dict(state, strict=True)
    assert not missing and not unexpected
    return module.eval()


# --- pure functions -----------------------------------------------------------


@pytest.mark.parametrize("r", [2, 3, 4])
def test_avg_pool_matches_jax(r):
    x = _x((2, 8, 14, 13, 5), r)  # extents not divisible by r: VALID floor
    want = np.asarray(jax_gc.avg_pool(jnp.asarray(x), r))
    np.testing.assert_allclose(avg_pool(torch.from_numpy(x), r).numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pool", [(2, 2, 2), (1, 2, 2), (1, 1, 1)])
def test_max_pool_and_unpool_match_jax_on_ties(pool):
    x = _x((2, 4, 6, 8, 3), 1, integer=True)
    jp, ja = jax_gc.max_pool_with_argmax(jnp.asarray(x), pool)
    tp, ta = max_pool_with_argmax(torch.from_numpy(x), pool)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))  # first max wins
    # channel-doubled values scatter through the repeated argmax channels
    v = _x((*tp.shape[:-1], 6), 2)
    want = jax_gc.max_unpool_scatter(jnp.asarray(v), ja, pool)
    got = max_unpool_scatter(torch.from_numpy(v), ta, pool)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_window_partition_and_reverse_match_jax():
    x = _x((2, 8, 14, 12, 3), 3)
    want = jax_window.window_partition(jnp.asarray(x), (4, 7, 6))
    got = window_partition(torch.from_numpy(x), (4, 7, 6))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(window_reverse(got, (4, 7, 6), (8, 14, 12)).numpy(), x)


# --- modules ------------------------------------------------------------------


@pytest.mark.parametrize("kernel,stride", [((1, 3, 3), (1, 1, 1)), ((3, 3, 3), (1, 2, 2)), ((3, 3, 3), (2, 2, 2))])
def test_stacked_conv_blocks_match_jax(kernel, stride):
    x = _x((2, 8, 14, 12, 6), 4)
    jmod = jax_blocks.StackedConvBlocks(
        num_convs=2, features=C, kernel_size=kernel, first_stride=stride,
        norm="batch", dtype=jnp.float32,
    )
    v, want = _jax_apply(jmod, x, 4)
    port = _port(StackedConvBlocks(2, 6, C, kernel, stride),
                 conv_blocks_state(v["params"], v["batch_stats"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_ffn_matches_jax():
    x = _x((2, 4, 7, 6, C), 5)
    jmod = jax_graphers.FFN(hidden_features=4 * C, out_features=C, act_name="leakyrelu")
    v, want = _jax_apply(jmod, x, 5)
    port = _port(FFN(C, 4 * C, 3, act_name="leakyrelu"),
                 ffn_state(v["params"], v["batch_stats"], 3))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize(
    "img,pool,r,k,norm",
    [
        ((8, 14, 12), (2, 2, 2), 2, 9, "instance"),  # pooled 168 nodes, 18 candidates
        ((4, 7, 6), (1, 1, 1), 1, 14, "instance"),  # self-graph
        ((8, 14, 12), (1, 1, 1), 2, 8, "batch"),
    ],
)
def test_pool_grapher_matches_jax(img, pool, r, k, norm):
    x = _x((2, *img, C), 6)
    jmod = jax_graphers.PoolGrapher(
        img_shape=img, pool_size=pool, k=k, reduce_ratio=r, act_name="leakyrelu",
        norm=norm, norm_op="batch", groups=6, dtype=jnp.float32,
    )
    v, want = _jax_apply(jmod, x, 6)
    pooled = [s // p for s, p in zip(img, pool)]
    n, m = int(np.prod(pooled)), int(np.prod([s // r for s in pooled]))
    table = torch.tensor(relative_pos_bias(C, n, m, 3))[None]
    port = PoolGrapher(C, table, pool_size=pool, k=k, reduce_ratio=r, groups=6,
                       act_name="leakyrelu", norm=norm)
    port = _port(port, grapher_state(
        v["params"], v["batch_stats"], v["constants"], graph_norm=norm, dims=3,
    ))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shift", [(2, 3, 3), (0, 0, 0)])
def test_swin_grapher_matches_jax(shift):
    window = (4, 7, 6)
    x = _x((2, 8, 14, 12, C), 7)
    jmod = jax_graphers.SwinGrapher(
        window_size=window, shift_size=shift, k=7, act_name="leakyrelu",
        norm_op="batch", groups=6, dtype=jnp.float32,
    )
    v, want = _jax_apply(jmod, x, 7)
    table = torch.tensor(relative_pos_bias(C, 168, 168, 3))[None]
    port = SwinGrapher(C, table, window_size=window, shift_size=shift, k=7,
                       groups=6, act_name="leakyrelu")
    port = _port(port, grapher_state(
        v["params"], v["batch_stats"], v["constants"], graph_norm="batch", dims=3,
    ))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_relative_pos_bias_matches_jax():
    from nextou_tpu.core.pos_embed import relative_pos_bias as jax_bias

    for args in [(12, 168, 168, 3), (12, 1344, 168, 3), (16, 64, 16, 2)]:
        np.testing.assert_array_equal(relative_pos_bias(*args), jax_bias(*args))
