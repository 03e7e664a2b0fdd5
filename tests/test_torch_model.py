"""The PyTorch port's NexToU network against the JAX package's, on the CPU.

The same variables (fast_init + randomized norms, made from a numpy seed) go
into ``nextou_tpu.models.NexToU`` and, through
``nextou_tpu_torch.compat.variables_to_state_dict``, into the port. The
JAX model's kNN runs through its plain reference path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextou_tpu.compat.torch_import import torch_state_dict_to_variables
from nextou_tpu.models import NexToU as JaxNexToU
from nextou_tpu.models import presets as jax_presets
from nextou_tpu.utils import fast_init
from nextou_tpu_torch.compat import variables_to_state_dict
from nextou_tpu_torch.models import NexToU
from nextou_tpu_torch.models import presets
from nextou_tpu_torch.nn.layers import HE_GAIN_SQ
from nextou_tpu_torch.utils import init_weights

# f32 on both sides; the sums run in another order (oneDNN vs XLA): the
# tolerance of tests/test_torch_import.py. That f32 noise can also flip a kNN
# selection where two candidates lie within ~1e-6 of the k-th distance (a
# few of the ~10^5 rows per forward here); the voxels downstream of such a
# row may differ by more, so at most MAX_OFF of them may lie outside it.
ATOL, RTOL = 2e-3, 1e-3
MAX_OFF = 1e-3


def assert_close_but_near_ties(got, want, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all(), err_msg
    off = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    assert off.mean() <= MAX_OFF, f"{err_msg}: {off.mean():.2e} of voxels off"


def randomized(variables, seed):
    """fast_init leaves norms at identity; give every norm scale, bias and
    running statistic random values so that their mapping is checked. The
    He-normal kernels are halved: with running statistics that do not match
    the activations, full-scale kernels grow them to ~1e5 by the logits."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if path[0].key == "constants":
            return a
        if name == "kernel":
            return 0.5 * a
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def jax_variables(model, x, seed):
    return randomized(fast_init(model, seed, jnp.asarray(x), train=False), seed)


def port_from_variables(spec, variables):
    model = NexToU(spec)
    model.load_state_dict(variables_to_state_dict(variables, spec))
    return model.eval()


@pytest.fixture
def jax_knn_plain(monkeypatch):
    # tests/test_kernels.py turns the Pallas interpreter on process-wide
    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "0")


@pytest.mark.parametrize("deep_supervision", [True, False])
def test_small_3d_forward_matches_jax(deep_supervision, jax_knn_plain):
    jspec = jax_presets.small_3d_spec(deep_supervision=deep_supervision)
    spec = presets.small_3d_spec(deep_supervision=deep_supervision)
    x = np.random.default_rng(0).standard_normal(
        (2, *spec.patch_size, spec.in_channels)
    ).astype(np.float32)
    jmodel = JaxNexToU(spec=jspec, dtype=jnp.float32)
    variables = jax_variables(jmodel, x[:1], seed=3)
    want = jmodel.apply(variables, jnp.asarray(x), train=False)

    with torch.no_grad():
        got = port_from_variables(spec, variables)(torch.from_numpy(x))
    if not deep_supervision:
        want, got = [want], [got]
    assert len(got) == len(want) == (5 if deep_supervision else 1)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == torch.float32, g.dtype
        assert_close_but_near_ties(g.numpy(), w, err_msg=f"output {i}")


def test_state_dict_round_trip_reproduces_jax_variables():
    jspec = jax_presets.small_3d_spec()
    spec = presets.small_3d_spec()
    x = np.zeros((1, *spec.patch_size, 1), np.float32)
    template = fast_init(JaxNexToU(spec=jspec), 5, jnp.asarray(x), train=False)
    variables = randomized(template, 5)
    port = port_from_variables(spec, variables)
    back = torch_state_dict_to_variables(port.state_dict(), template, jspec)
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, w in flat_want:
        np.testing.assert_array_equal(np.asarray(flat_got[path]), np.asarray(w), err_msg=str(path))


def test_relative_pos_tables_are_built_once_and_shared():
    model = NexToU(presets.small_3d_spec())
    tables = {
        name: b
        for name, b in model.named_buffers(remove_duplicate=False)
        if name.endswith("relative_pos")
    }
    assert len(tables) == 14  # one per grapher
    ptrs = {b.data_ptr() for b in tables.values()}
    assert len(ptrs) == 3  # (10752, 168), (1344, 168), (168, 168) at 12 channels


@pytest.mark.parametrize("name", ["flagship_3d_spec", "ravir_2d_spec", "small_3d_spec"])
def test_spec_matches_jax(name):
    assert dataclasses.asdict(getattr(presets, name)()) == dataclasses.asdict(
        getattr(jax_presets, name)()
    )


def test_init_weights_is_seeded_he_normal():
    spec = presets.small_3d_spec(features=(6, 12, 12, 12, 12, 12))
    a = init_weights(NexToU(spec), seed=7).state_dict()
    b = init_weights(NexToU(spec), seed=7).state_dict()
    assert a.keys() == b.keys()
    for name in a:
        torch.testing.assert_close(a[name], b[name], rtol=0, atol=0)
    w = a["decoder.transpconvs.0.weight"]  # ConvTranspose (I, O, *k): fan-in O*prod(k)
    fan_in = w.shape[1] * int(np.prod(w.shape[2:]))
    assert abs(w.std().item() / (HE_GAIN_SQ / fan_in) ** 0.5 - 1) < 0.1
    assert torch.all(a["encoder.stages.0.0.convs.0.norm.weight"] == 1)
    assert torch.all(a["encoder.stages.0.0.convs.0.conv.bias"] == 0)
