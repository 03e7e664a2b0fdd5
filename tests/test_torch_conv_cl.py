"""The port's channels-last conv (``nextou_tpu_torch/tools/exp_conv_kernel.py``,
T3) against the JAX tool ``tools/exp_conv_kernel.py`` on the CPU.

The same inputs, made from a numpy seed, go through the JAX tool's
``pallas_conv`` and ``csub_conv`` (Pallas in TPU interpret mode) and its
``xla_conv``, and through the port's entry points, which on a CPU tensor take
the plain version: a sum over the taps in f32, the arithmetic of the CUDA
kernel. Both sides keep the JAX tool's layouts, ``(N, D, H, W, C)`` and
``(kd, kh, kw, C, Co)``.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental.pallas import tpu as pltpu

from nextou_tpu_torch.tools import exp_conv_kernel as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    """``tools/exp_conv_kernel.py`` loaded as a module. ``tools/`` is not a
    package, and importing the file turns on the JAX compilation cache: that
    call is made a no-op while the file loads."""
    from nextou_tpu.utils import cache

    patch = pytest.MonkeyPatch()
    patch.setattr(cache, "enable_compilation_cache", lambda *a, **k: None)
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_exp_conv_kernel", os.path.join(REPO, "tools", "exp_conv_kernel.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        patch.undo()
    return module


def _case(shape, co, kernel, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((*kernel, shape[-1], co)) * 0.1).astype(np.float32)
    return x, w


def _tolerance(want):
    """The JAX tool's own bound: 1e-3 of the largest output, at least 1e-3."""
    return 1e-3 * max(1.0, float(np.abs(want).max()))


# the JAX tool's CASES at its check() size, with 3-5 input channels (its
# interpreted kernel takes seconds per case at these sizes)
_PALLAS_CASES = [
    ("e0b", (2, 1, 16, 12, 3), 4, (1, 3, 3), (1, 1, 1)),
    ("e1a", (2, 8, 16, 12, 3), 5, (3, 3, 3), (1, 2, 2)),
    ("e1b", (2, 8, 16, 12, 4), 4, (3, 3, 3), (1, 1, 1)),
    ("e2a", (2, 8, 16, 12, 5), 3, (3, 3, 3), (2, 2, 2)),
]


@pytest.mark.parametrize("name,shape,co,kernel,stride", _PALLAS_CASES)
def test_plain_conv_matches_pallas_conv_and_xla_conv(jax_tool, name, shape, co, kernel, stride):
    x, w = _case(shape, co, kernel, seed=len(name))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_tool.pallas_conv(jnp.asarray(x), jnp.asarray(w), stride))
    want_xla = np.asarray(jax_tool.xla_conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = port.pallas_conv(torch.from_numpy(x), torch.from_numpy(w), stride).numpy()
    assert got.shape == want.shape == tuple(n // s for n, s in zip(shape[:4], (1, *stride))) + (co,)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tolerance(want))
    # the JAX tool's floor extents against its XLA conv, cropped as the
    # port's library conv is
    np.testing.assert_allclose(got, want_xla[:, :got.shape[1], :got.shape[2], :got.shape[3]],
                               rtol=0, atol=_tolerance(want_xla))
    lib = port.xla_conv(torch.from_numpy(x), torch.from_numpy(w), stride).numpy()
    np.testing.assert_allclose(got, lib, rtol=0, atol=1e-4 * max(1.0, float(np.abs(lib).max())))


@pytest.mark.parametrize("kernel", [(3, 3, 3), (1, 3, 3)])
def test_plain_conv_matches_csub_conv(jax_tool, kernel):
    x, w = _case((2, 8, 16, 12, 5), 4, kernel, seed=sum(kernel))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_tool.csub_conv(jnp.asarray(x), jnp.asarray(w)))
    got = port.csub_conv(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (2, 8, 16, 12, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=_tolerance(want))


@settings(max_examples=25, deadline=None)
@given(
    kernel=st.tuples(*[st.sampled_from([1, 3])] * 3),
    stride=st.tuples(*[st.sampled_from([1, 2])] * 3),
    spatial=st.tuples(st.integers(2, 7), st.integers(2, 9), st.integers(2, 11)),
    c=st.integers(1, 6), co=st.integers(1, 5), seed=st.integers(0, 2**16),
)
def test_plain_conv_is_the_cropped_library_conv(kernel, stride, spatial, c, co, seed):
    # odd extents under a stride: F.conv3d gives ceil(n / 2) outputs, T3 n // 2
    x, w = _case((2, *spatial, c), co, kernel, seed)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = port.conv_cl_reference(xt, wt, stride)
    lib = F.conv3d(xt.permute(0, 4, 1, 2, 3), wt.permute(4, 3, 0, 1, 2), None, stride,
                   [(k - 1) // 2 for k in kernel])
    out = tuple(n // s for n, s in zip(spatial, stride))
    assert got.shape == (2, *out, co)
    assert all(a >= b for a, b in zip(lib.shape[2:], out))
    want = lib[:, :, :out[0], :out[1], :out[2]].permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(port.xla_conv(xt, wt, stride), want, rtol=0, atol=0)


def test_odd_extent_under_a_stride_gives_one_output_fewer():
    x, w = _case((1, 5, 7, 9, 2), 3, (3, 3, 3), seed=3)
    got = port.pallas_conv(torch.from_numpy(x), torch.from_numpy(w), (2, 2, 2))
    assert got.shape == (1, 2, 3, 4, 3)  # F.conv3d: (1, 3, 3, 4, 5) channels-first


def test_plain_conv_rounds_once_and_refuses_what_t3_does_not_take():
    x, w = _case((1, 4, 6, 8, 7), 5, (3, 3, 3), seed=4)
    xt, wt = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = port.conv_cl_reference(xt, wt, (1, 1, 1))
    want = port.conv_cl_reference(xt.float(), wt.float(), (1, 1, 1)).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    with pytest.raises(ValueError):
        port.pallas_conv(xt, wt, (3, 1, 1))
    with pytest.raises(ValueError):
        port.pallas_conv(xt, wt[:2], (1, 1, 1))  # a kernel dim of 2
    with pytest.raises(ValueError):
        port.pallas_conv(xt[:, :1], wt, (2, 1, 1))  # no output depth
    with pytest.raises(ValueError):
        port.csub_conv(xt, wt, (1, 2, 2))  # csub_conv is stride 1 only


def test_the_kernel_refuses_cpu_tensors():
    x, w = _case((1, 2, 4, 4, 3), 2, (1, 3, 3), seed=5)
    port.conv_cl_cuda.launches = 0
    with pytest.raises(ValueError, match="CUDA"):
        port.conv_cl_cuda(torch.from_numpy(x), torch.from_numpy(w), (1, 1, 1))
    assert port.conv_cl_cuda.launches == 0


def test_cases_are_the_jax_tools(jax_tool):
    assert port.CASES == jax_tool.CASES
    small = [(n, (2, 8 if s[1] > 1 else 1, 16, 12, s[4]), co, k, st_)
             for n, s, co, k, st_ in jax_tool.CASES]
    assert port.small_cases() == small
