"""The port's 2D NexToU family against the JAX package's, on the CPU, in f32:
the 2D graphers, the 2D window partition, the 2D relative-position bias, a
narrow network with the RAVIR schedule (``ravir_2d_spec``'s seven stages,
kernel sizes and strides) and the plans of a RAVIR-like fingerprint.

Inputs are made from a numpy seed; the JAX modules' variables reach the port
through ``nextou_tpu_torch.compat`` (``variables_to_state_dict`` and its
block helpers). The JAX side reaches its kNN through its plain path. The
narrow network's JAX forward runs once per module (a fixture), the port's in
one torch thread.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextou_tpu.core import window as jax_window
from nextou_tpu.core.pos_embed import relative_pos_bias as jax_bias
from nextou_tpu.models import NexToU as JaxNexToU
from nextou_tpu.models import spec as jax_spec
from nextou_tpu.nn import graphers as jax_graphers
from nextou_tpu.plans import planner as jax_planner
from nextou_tpu_torch.compat.weights import grapher_state
from nextou_tpu_torch.core.pos_embed import relative_pos_bias
from nextou_tpu_torch.core.window import window_partition, window_reverse
from nextou_tpu_torch.models import spec as port_spec
from nextou_tpu_torch.models.presets import ravir_2d_spec
from nextou_tpu_torch.nn.graphers import PoolGrapher, SwinGrapher
from nextou_tpu_torch.plans.planner import plan_experiment
from nextou_tpu_torch.tools.synthetic import NARROW_RAVIR_2D, RAVIR_DATASET_JSON
from tests.test_torch_model import (
    assert_close_but_near_ties,
    jax_variables,
    port_from_variables,
)
from tests.test_torch_modules import _jax_apply, _port, _x

# the graphers: f32 on both sides, sums in another order (oneDNN/MKL vs XLA),
# tests/test_torch_modules.py's tolerance
TOL = dict(rtol=1e-4, atol=1e-4)
C = 8  # divisible by the 2D group count (4) and the 2D sin-cos embedding (4)


@pytest.fixture(autouse=True)
def jax_knn_plain(monkeypatch):
    # tests/test_kernels.py turns the Pallas interpreter on process-wide
    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "0")


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_window_partition_and_reverse_2d_match_jax():
    x = _x((2, 16, 14, 3), 3)
    want = jax_window.window_partition(jnp.asarray(x), (8, 7))
    got = window_partition(torch.from_numpy(x), (8, 7))
    assert got.shape == (8, 8, 7, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(window_reverse(got, (8, 7), (16, 14)).numpy(), x)


@pytest.mark.parametrize("args", [(8, 56, 56, 2), (8, 896, 224, 2), (16, 224, 224, 2),
                                  (512, 56, 56, 2), (12, 16, 16, 2)])
def test_relative_pos_bias_2d_matches_jax(args):
    # the same numpy and scipy on both sides: bit for bit
    np.testing.assert_array_equal(relative_pos_bias(*args), jax_bias(*args))


@pytest.mark.parametrize(
    "img,pool,r,k",
    [
        ((16, 14), (2, 2), 2, 9),  # RAVIR's s3: pooled 56 nodes, 14 candidates
        ((8, 7), (1, 1), 1, 14),  # s4-s6: a self-graph
    ],
)
def test_pool_grapher_2d_matches_jax(img, pool, r, k):
    x = _x((2, *img, C), 6)
    jmod = jax_graphers.PoolGrapher(
        img_shape=img, pool_size=pool, k=k, reduce_ratio=r, act_name="leakyrelu",
        norm="instance", norm_op="batch", groups=4, dtype=jnp.float32,
    )
    v, want = _jax_apply(jmod, x, 6)
    pooled = [s // p for s, p in zip(img, pool)]
    n, m = int(np.prod(pooled)), int(np.prod([s // r for s in pooled]))
    table = torch.tensor(relative_pos_bias(C, n, m, 2))[None]
    port = PoolGrapher(C, table, pool_size=pool, k=k, reduce_ratio=r, groups=4,
                       act_name="leakyrelu", norm="instance")
    port = _port(port, grapher_state(
        v["params"], v["batch_stats"], v["constants"], graph_norm="instance", dims=2,
    ))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shift", [(4, 3), (0, 0)])
def test_swin_grapher_2d_matches_jax(shift):
    window = (8, 7)
    x = _x((2, 16, 14, C), 7)
    jmod = jax_graphers.SwinGrapher(
        window_size=window, shift_size=shift, k=7, act_name="leakyrelu",
        norm_op="batch", groups=4, dtype=jnp.float32,
    )
    v, want = _jax_apply(jmod, x, 7)
    table = torch.tensor(relative_pos_bias(C, 56, 56, 2))[None]
    port = SwinGrapher(C, table, window_size=window, shift_size=shift, k=7,
                       groups=4, act_name="leakyrelu")
    port = _port(port, grapher_state(
        v["params"], v["batch_stats"], v["constants"], graph_norm="batch", dims=2,
    ))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# --- a narrow network with the RAVIR schedule ------------------------------------------

# ravir_2d_spec's seven stages, kernel sizes and strides at narrow widths
# (synthetic.NARROW_RAVIR_2D, where its widths are explained), at a patch whose
# bottleneck keeps 4 x 4 = 16 nodes
def narrow_ravir_spec(deep_supervision: bool = True):
    return port_spec.build_model_spec(**NARROW_RAVIR_2D, deep_supervision=deep_supervision)


@pytest.fixture(scope="module")
def narrow_jax_forward():
    """The JAX network's deep-supervised outputs and its variables, once: the
    seeded input, 2 x 256 x 256 x 1."""
    jspec = jax_spec.build_model_spec(**NARROW_RAVIR_2D, deep_supervision=True)
    x = np.random.default_rng(0).standard_normal((2, 256, 256, 1)).astype(np.float32)
    jmodel = JaxNexToU(spec=jspec, dtype=jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        # a module fixture runs before the function-scoped jax_knn_plain
        mp.setenv("NEXTOU_PALLAS_INTERPRET", "0")
        variables = jax_variables(jmodel, x[:1], seed=3)
        # one compile of the whole forward (op by op it takes seven times as long)
        forward = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
        want = [np.asarray(w) for w in forward(variables, jnp.asarray(x))]
    return x, variables, want


def test_narrow_ravir_spec_matches_jax_and_the_preset_schedule():
    spec = narrow_ravir_spec()
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        jax_spec.build_model_spec(**NARROW_RAVIR_2D, deep_supervision=True))
    ravir = ravir_2d_spec()
    # the preset's geometry: the same stages, kernels, strides and GNN layout
    for a, b in zip((*spec.encoder, *spec.decoder), (*ravir.encoder, *ravir.decoder)):
        assert (a.kernel_size, len(a.gnn), [g.kind for g in a.gnn]) == (
            b.kernel_size, len(b.gnn), [g.kind for g in b.gnn])
    assert [s.stride for s in spec.encoder] == [s.stride for s in ravir.encoder]
    assert spec.encoder[-1].img_shape == (4, 4)


@pytest.mark.parametrize("deep_supervision", [True, False])
def test_narrow_ravir_forward_matches_jax(deep_supervision, narrow_jax_forward):
    x, variables, want = narrow_jax_forward
    spec = narrow_ravir_spec(deep_supervision)
    with torch.no_grad():
        got = port_from_variables(spec, variables)(torch.from_numpy(x))
    if not deep_supervision:
        # the network without deep supervision returns the full-resolution
        # head alone, the first of the deep-supervised outputs
        want, got = want[:1], [got]
    assert len(got) == len(want) == (6 if deep_supervision else 1)
    # tests/test_torch_model.py's ATOL/RTOL/MAX_OFF: f32 in another sum order,
    # and the kNN near ties it may flip
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == torch.float32, g.dtype
        assert_close_but_near_ties(g.numpy(), w, err_msg=f"output {i}")


# --- the plans of a RAVIR-like fingerprint ---------------------------------------------

# 23 single-channel 768 x 768 training images in nnU-Net's 2D layout (one
# slice, the slice axis at 999); RAVIR's dataset.json (synthetic.RAVIR_DATASET_JSON)
RAVIR_FINGERPRINT = {
    "spacings": [[999.0, 1.0, 1.0]] * 23,
    "shapes_after_crop": [[1, 768, 768]] * 23,
    "median_relative_size_after_cropping": 1.0,
    "foreground_intensity_properties_per_channel": {
        "0": {"max": 255.0, "mean": 92.5, "median": 90.0, "min": 0.0,
              "percentile_00_5": 12.0, "percentile_99_5": 231.0, "std": 41.25}},
}


def test_ravir_like_plans_equal_the_jax_package():
    got = plan_experiment(RAVIR_FINGERPRINT, RAVIR_DATASET_JSON, dataset_name="Dataset014_RAVIR")
    want = jax_planner.plan_experiment(RAVIR_FINGERPRINT, RAVIR_DATASET_JSON,
                                       dataset_name="Dataset014_RAVIR")
    # the same numpy on both sides: the JSON text equal
    assert json.dumps(got, indent=2) == json.dumps(want, indent=2)
    cfgs = got["configurations"]
    assert cfgs["2d_nextou"] == {"inherits_from": "2d", "patch_size": [640, 640],
                                 "UNet_class_name": "NexToU"}
    assert (cfgs["2d"]["batch_size"], len(cfgs["2d"]["pool_op_kernel_sizes"])) == (3, 8)
    assert cfgs["2d"]["UNet_base_num_features"] == 32
    assert cfgs["2d"]["unet_max_num_features"] == 512


# --- the lockstep protocol of the card's train-step checks -----------------------------


def test_lockstep_holds_the_cpu_against_itself_and_probes_one_ulp():
    # chip_smoke.py's phases 23 (a) and 24 (b) hold the card's steps against the
    # CPU's with nextou_tpu_torch.tools.lockstep; on the CPU against itself, one
    # step of the narrow RAVIR network with the RAVIR BTI loss is the same bits
    # (every distance 0, no step witnessed), and the probe at 1 + 1e-7 measures
    # the CPU's own move: finite, and non-zero in the update
    from nextou_tpu_torch.tools.lockstep import WIDTHS, lockstep, ravir_loss_spec
    from nextou_tpu_torch.tools.synthetic import vessel_batch
    from nextou_tpu_torch.train import make_optimizer

    loss = ravir_loss_spec()
    assert (loss.weight_ti, loss.ti.dim, loss.ti.connectivity) == (1e-4, 2, 8)
    spec = port_spec.build_model_spec(**{**NARROW_RAVIR_2D, "patch_size": (128, 128)},
                                      deep_supervision=True)
    batch = vessel_batch(np.random.default_rng(0), 2, spec.patch_size)
    worst, witnessed, probed = lockstep(torch.device("cpu"), spec, [batch], [0], [loss],
                                        make_optimizer(1e-2), 0, "cpu", 0, probe=(1e-7,))
    assert worst == dict.fromkeys(WIDTHS, 0.0) and witnessed == 0
    assert len(probed) == 1 and set(probed[0]) == {1e-7}
    moved = probed[0][1e-7]
    assert set(moved) == set(WIDTHS) and all(np.isfinite(v) for v in moved.values())
    assert moved["update"] > 0
