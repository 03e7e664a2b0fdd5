"""The port's plain and residual U-Nets, PReLU, the plain Grapher and
``nnUNetTrainer`` against the JAX package's, on the CPU, in f32.

The same variables (``fast_init``, randomized from a numpy seed, kernels
halved) go into the JAX module and, through
``nextou_tpu_torch.compat.variables_to_state_dict`` or its block helpers,
into the port's. Logits within atol 1e-4 / rtol 1e-4: f32 on both sides,
sums in another order (oneDNN vs XLA). The JAX kNN of the Grapher runs
through its plain reference path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextou_tpu.models.plain_unet import PlainConvUNet as JaxPlainConvUNet
from nextou_tpu.models.plain_unet import build_plain_unet_spec as jax_plain_spec
from nextou_tpu.models.residual_unet import ResidualEncoderUNet as JaxResidualEncoderUNet
from nextou_tpu.models.residual_unet import build_residual_encoder_unet_spec as jax_res_spec
from nextou_tpu.nn import graphers as jax_graphers
from nextou_tpu.nn import layers as jax_layers
from nextou_tpu.train import get_trainer_class as jax_trainer_class
from nextou_tpu.utils import fast_init
from nextou_tpu_torch.compat import load_train_state, variables_to_state_dict
from nextou_tpu_torch.compat.weights import ffn_state, grapher_state
from nextou_tpu_torch.core.pos_embed import relative_pos_bias
from nextou_tpu_torch.models import (
    PlainConvUNet,
    ResidualEncoderUNet,
    build_plain_unet_spec,
    build_residual_encoder_unet_spec,
)
from nextou_tpu_torch.nn import layers
from nextou_tpu_torch.nn.graphers import FFN, Grapher
from nextou_tpu_torch.train import get_trainer_class
from nextou_tpu_torch.utils import init_weights
from tests.test_torch_model import randomized
from tests.test_torch_train import _two_pass_batch_variance
from tests.test_train_integration import DATASET_JSON, TINY_PLANS

TOL = dict(rtol=1e-4, atol=1e-4)

# narrow networks: 2D and 3D, the 3D one anisotropic in its first stage as
# the planner's 3d_fullres is
GEOMETRY = {
    "2d": dict(patch_size=(32, 32), n_stages=4, features_per_stage=[4, 8, 16, 16],
               kernel_sizes=[[3, 3]] * 4, strides=[[1, 1], [2, 2], [2, 2], [2, 2]]),
    "3d": dict(patch_size=(8, 16, 16), n_stages=4, features_per_stage=[4, 8, 12, 12],
               kernel_sizes=[[1, 3, 3]] + [[3, 3, 3]] * 3,
               strides=[[1, 1, 1], [1, 2, 2], [2, 2, 2], [2, 2, 2]]),
}
ARCHS = {
    "plain": (build_plain_unet_spec, jax_plain_spec, PlainConvUNet, JaxPlainConvUNet,
              "n_conv_per_stage", [2, 2, 2, 2]),
    "residual": (build_residual_encoder_unet_spec, jax_res_spec, ResidualEncoderUNet,
                 JaxResidualEncoderUNet, "n_blocks_per_stage", [1, 2, 2, 2]),
}


@pytest.fixture(autouse=True)
def jax_knn_plain(monkeypatch):
    # tests/test_kernels.py turns the Pallas interpreter on process-wide
    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "0")


def _specs(arch: str, dims: str, deep_supervision: bool, in_channels: int = 2):
    port_build, jax_build, _, _, n_name, n_enc = ARCHS[arch]
    kw = dict(GEOMETRY[dims], in_channels=in_channels, num_classes=3,
              n_conv_per_stage_decoder=[1, 2, 1], deep_supervision=deep_supervision)
    kw[n_name] = n_enc
    return port_build(**kw), jax_build(**kw)


@pytest.mark.parametrize("deep_supervision", [True, False])
@pytest.mark.parametrize("dims", ["2d", "3d"])
@pytest.mark.parametrize("arch", ["plain", "residual"])
def test_unet_matches_jax(arch, dims, deep_supervision, monkeypatch):
    """Eval mode (running statistics) and train mode (batch statistics, and
    the running statistics it updates) of the plain and residual U-Nets."""
    _two_pass_batch_variance(monkeypatch)
    spec, jspec = _specs(arch, dims, deep_supervision)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    _, _, port_cls, jax_cls, _, _ = ARCHS[arch]
    x = np.random.default_rng(1).standard_normal(
        (2, *spec.patch_size, spec.in_channels)).astype(np.float32)
    jmodel = jax_cls(spec=jspec, dtype=jnp.float32)
    variables = randomized(fast_init(jmodel, 3, jnp.asarray(x[:1]), train=False), 3)
    sd = variables_to_state_dict(variables, spec)
    model = port_cls(spec)
    assert sd.keys() == model.state_dict().keys()
    model.load_state_dict(sd)
    if arch == "residual":
        assert spec.stem_features == 4 and "encoder.stem.convs.0.conv.weight" in sd
        assert "encoder.stages.1.0.blocks.0.skip.conv.weight" in sd
        assert "encoder.stages.1.0.blocks.1.skip.conv.weight" not in sd

    want = jmodel.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    want, got = (want, got) if deep_supervision else ([want], [got])
    assert len(got) == len(want) == (3 if deep_supervision else 1)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    want, new_vars = jmodel.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x))
    want, got = (want, got) if deep_supervision else ([want], [got])
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    moved = variables_to_state_dict({**variables, **new_vars}, spec)
    for name, value in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(value.numpy(), moved[name].numpy(), err_msg=name, **TOL)


def test_residual_init_zeroes_the_last_norm_of_each_block():
    """``init_weights`` and ``fast_init`` start each residual block's last
    norm scale at 0 and every other norm scale at 1."""
    spec, jspec = _specs("residual", "3d", False)
    model = init_weights(ResidualEncoderUNet(spec), seed=0)
    variables = fast_init(JaxResidualEncoderUNet(spec=jspec), 0,
                          jnp.zeros((1, *spec.patch_size, 2)), train=False)
    theirs = variables_to_state_dict(variables, spec)
    for name, p in model.state_dict().items():
        if name.endswith("norm.weight"):
            want = 0.0 if name.endswith("conv2.norm.weight") else 1.0
            assert torch.all(p == want) and np.all(theirs[name].numpy() == want), name


@pytest.mark.parametrize("n_prelu", [1, 6])
def test_prelu_matches_jax(n_prelu):
    x = np.random.default_rng(2).standard_normal((3, 5, 6)).astype(np.float32)
    jmod = jax_layers.ActLayer("prelu", n_prelu=n_prelu)
    alpha = np.random.default_rng(3).uniform(-0.5, 0.5, n_prelu).astype(np.float32)
    want = jmod.apply({"params": {"PReLU_0": {"alpha": alpha}}}, jnp.asarray(x))
    port = layers.ActLayer("prelu", n_prelu=n_prelu)
    assert isinstance(port, layers.PReLU) and torch.all(port.weight == 1e-2)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(alpha))
        got = port(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError):
        layers.act("prelu", torch.from_numpy(x))
    with pytest.raises(NotImplementedError):
        jax_layers.act("prelu", jnp.asarray(x))


def test_ffn_with_prelu_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 4, 6, 12)).astype(np.float32)
    jmod = jax_graphers.FFN(hidden_features=24, out_features=12, act_name="prelu")
    v = randomized(fast_init(jmod, 4, jnp.asarray(x), train=False), 4)
    want = jmod.apply(v, jnp.asarray(x), train=False)
    port = FFN(12, 24, 2, act_name="prelu")
    port.load_state_dict(ffn_state(v["params"], v["batch_stats"], 2))
    assert "act.weight" in port.state_dict()
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("rel,r,norm,act", [
    (False, 1, "instance", "leakyrelu"),
    (True, 2, "batch", "prelu"),
])
def test_grapher_matches_jax(rel, r, norm, act):
    """The plain Grapher over the whole map (K1's function on the card): the
    JAX module's default (no position bias, instance norm), and a reduced
    candidate set with the position bias, BatchNorm and PReLU."""
    C = 12
    x = np.random.default_rng(5).standard_normal((2, 4, 8, 8, C)).astype(np.float32)
    jmod = jax_graphers.Grapher(k=6, reduce_ratio=r, act_name=act, norm=norm, groups=6,
                                use_relative_pos=rel, dtype=jnp.float32)
    v = randomized(fast_init(jmod, 5, jnp.asarray(x), train=False), 5)
    want = jmod.apply(v, jnp.asarray(x), train=False)
    n, m = 4 * 8 * 8, (4 // r) * (8 // r) * (8 // r)
    table = torch.tensor(relative_pos_bias(C, n, m, 3))[None] if rel else None
    port = Grapher(C, table, dims=3, k=6, reduce_ratio=r, groups=6, act_name=act, norm=norm)
    state = grapher_state(v["params"], v["batch_stats"], v.get("constants", {}),
                          graph_norm=norm, dims=3)
    port.load_state_dict(state)
    assert ("relative_pos" in state) == rel
    assert ("graph_conv.gconv.nn.2.weight" in state) == (act == "prelu")
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


RES_PLANS = {**TINY_PLANS, "configurations": {"2d_res": {
    **TINY_PLANS["configurations"]["2d_tiny"], "UNet_class_name": "ResidualEncoderUNet",
    "n_conv_per_stage_encoder": [1, 2, 2, 2, 2]}}}


@pytest.mark.parametrize("plans,config", [(TINY_PLANS, "2d_tiny"), (RES_PLANS, "2d_res")])
def test_nnunet_trainer_first_step_matches_the_jax_trainer(plans, config, tmp_path, monkeypatch):
    """``nnUNetTrainer`` builds the plans' class (the same spec as the JAX
    trainer's) and, from the JAX trainer's initial state on the same batch,
    takes a first step with its loss within rtol 1e-4 in f32 (the rule of
    ``tests/test_torch_trainer.py``)."""
    from nextou_tpu.data import make_synthetic_dataset

    _two_pass_batch_variance(monkeypatch)
    folder = str(tmp_path / "data")
    make_synthetic_dataset(folder, n_cases=4, shape=(64, 64), num_classes=3)
    common = dict(preprocessed_folder=folder, remat=False, device_da=False, num_epochs=2,
                  num_iterations_per_epoch=4)
    jax_t = jax_trainer_class("nnUNetTrainer")(
        plans, config, 0, DATASET_JSON, output_folder=str(tmp_path / "jax"),
        compute_dtype=jnp.float32, **common).initialize()
    port_t = get_trainer_class("nnUNetTrainer")(
        plans, config, 0, DATASET_JSON, output_folder=str(tmp_path / "port"), device="cpu",
        loader_threads=1, **common).initialize()
    assert dataclasses.asdict(port_t.model_spec) == dataclasses.asdict(jax_t.model_spec)
    assert not any(st.gnn for st in port_t.model_spec.encoder)
    assert (port_t.model_spec.stem_features is not None) == (config == "2d_res")

    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) * (0.5 if path[-1].key == "kernel" else 1.0),
        jax_t.state.model_variables())
    jstate = jax_t.state.replace(params=variables["params"])
    trace = next(s for s in jstate.opt_state if "trace" in s._fields).trace
    load_train_state(port_t.state, variables, jax.tree_util.tree_map(np.asarray, trace),
                     int(jstate.step), port_t.model_spec)
    rng = np.random.default_rng(6)
    batch = {"data": rng.standard_normal((2, 64, 64, 1)).astype(np.float32),
             "seg": rng.integers(0, 3, (2, 64, 64)).astype(np.int32)}
    _, want = jax_t.train_step(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    _, got = port_t.train_step(port_t.state, batch)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-4)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-3)
