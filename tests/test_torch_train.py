"""The port's train step (optimizer, training-mode network, state) against
``nextou_tpu.train``, on the CPU in f32.

Weights move through ``nextou_tpu_torch.compat``; batches and gradients are
made with numpy from a seed. The He-normal kernels are halved, as in
``tests/test_torch_model.py``: a random network is chaotic under kNN
selection, and a near tie that the two frameworks' sums resolve differently
selects another neighbour in a few rows.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from nextou_tpu import losses as jl
from nextou_tpu import train as jt
from nextou_tpu.compat.torch_import import torch_state_dict_to_variables
from nextou_tpu.models import NexToU as JaxNexToU
from nextou_tpu.models import presets as jax_presets
from nextou_tpu.models.spec import build_model_spec as jax_build_model_spec
from nextou_tpu_torch import losses as pl
from nextou_tpu_torch import train as pt
from nextou_tpu_torch.compat import load_train_state
from nextou_tpu_torch.models import NexToU, presets
from nextou_tpu_torch.models.nextou import remat_flags
from nextou_tpu_torch.models.spec import build_model_spec
from nextou_tpu_torch.nn.conv_blocks import ConvNormAct
from nextou_tpu_torch.nn.layers import DropPath, LastDimBatchNorm
from tests.test_torch_model import randomized


# --- optimizer ---------------------------------------------------------------------


def test_poly_lr_matches_jax():
    want = jt.poly_lr(1e-2, 1000, 0.9, steps_per_epoch=250)
    got = pt.poly_lr(1e-2, 1000, 0.9, steps_per_epoch=250)
    for step in (0, 1, 249, 250, 12345, 249_999, 250_000, 400_000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5, atol=1e-12)
    assert got(400_000) == 0.0


@pytest.mark.parametrize("nesterov", [True, False])
def test_five_updates_match_optax_with_clipping_active(nesterov):
    rng = np.random.default_rng(0)
    shapes = [(6, 4, 3, 3), (6,), (12, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    # global norms around 20 and around 5: the clip at 12 acts on some steps
    grads = [
        [(scale * rng.standard_normal(s)).astype(np.float32) for s in shapes]
        for scale in (1.2, 0.3, 1.5, 0.2, 1.0)
    ]
    sched = dict(initial_lr=1e-2, max_steps=10, exponent=0.9, steps_per_epoch=2)
    jopt = jt.make_optimizer(jt.poly_lr(**sched), nesterov=nesterov)
    jparams = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jparams)

    opt = pt.make_optimizer(pt.poly_lr(**sched), nesterov=nesterov)
    tparams = [torch.from_numpy(p.copy()) for p in params]
    momentum = opt.init(tparams)
    clipped = 0
    for step, g in enumerate(grads):
        updates, jstate = jopt.update([jnp.asarray(a) for a in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        want_norm = float(optax.global_norm([jnp.asarray(a) for a in g]))
        clipped += want_norm > 12.0
        norm = opt.update([torch.from_numpy(a.copy()) for a in g], momentum, tparams, step)
        np.testing.assert_allclose(norm.item(), want_norm, rtol=1e-6)
        # one rounding more or less per product: rtol 1e-5 / atol 1e-7
        for got, want in zip(tparams, jparams):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)
    assert 0 < clipped < len(grads)
    trace = next(s for s in jstate if "trace" in s._fields).trace
    for got, want in zip(momentum, trace):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


# --- training-mode layers ------------------------------------------------------------


def test_batch_norm_running_statistics_match_flax():
    # flax stores the biased batch variance, torch.nn.BatchNorm the unbiased
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((2, 5, 7, 6)) + 1.5).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want, mutated = jbn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    stats = mutated["batch_stats"]

    last = LastDimBatchNorm(6, eps=1e-5).train()
    got = last(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(last.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(last.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5)
    unbiased = nn.BatchNorm1d(6).train()
    unbiased(torch.from_numpy(x).reshape(-1, 6))
    assert not np.allclose(unbiased.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-4)

    block = ConvNormAct(6, 6, (1, 1), (1, 1)).train()  # channels-first
    with torch.no_grad():
        block.conv.weight.copy_(torch.eye(6).reshape(6, 6, 1, 1))
        block.conv.bias.zero_()
    block(torch.from_numpy(x).movedim(-1, 1))
    np.testing.assert_allclose(block.norm.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5)

    # momentum 0 leaves the statistics exactly as they are; eval reads them
    before = last.running_var.clone(), last.running_mean.clone()
    last.momentum = 0.0
    last(torch.from_numpy(x) * 2)
    assert torch.equal(last.running_var, before[0]) and torch.equal(last.running_mean, before[1])
    last.eval()
    y = last(torch.from_numpy(x))
    assert torch.equal(last.running_var, before[0])
    assert not torch.allclose(y, got)


def test_drop_path():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 3, 5, generator=gen)
    drop = DropPath(0.25, gen).train()
    start = gen.get_state()
    y = drop(x)
    kept = (y != 0).reshape(64, -1).any(1)
    assert 30 < kept.sum() < 62
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert not y[~kept].any()
    gen.set_state(start)
    assert torch.equal(drop(x), y)  # the same draw from the same state
    assert drop.eval()(x) is x and DropPath(0.0, gen).train()(x) is x


# --- the network in training mode ----------------------------------------------------


def _stochastic_spec():
    """small_3d_spec with what the shipped specs leave off: a dilated,
    always-shuffled graph in one stage and a non-zero DropPath rate."""
    spec = presets.small_3d_spec(features=(4, 6, 6, 6, 6, 6))
    enc = list(spec.encoder)
    gnn = tuple(dataclasses.replace(b, dilation=2, k=3, drop_path=0.3) for b in enc[4].gnn)
    enc[4] = dataclasses.replace(enc[4], gnn=gnn)
    return dataclasses.replace(spec, encoder=tuple(enc), epsilon=1.0)


def _grads_and_stats(spec, remat, x, seed):
    model = NexToU(spec, remat=remat).train()
    pt.create_train_state(model, pt.make_optimizer(), seed)
    outs = model(torch.from_numpy(x))
    loss = sum(o.square().mean() for o in outs)
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    return loss, grads, dict(model.named_buffers()), model.generator.get_state()


@pytest.mark.parametrize("remat", [True, "big"])
def test_recomputed_stages_repeat_the_first_run(remat):
    # the recomputation draws the same DropPath mask and graph subset, and
    # updates the BatchNorm statistics once: bit-equal to no recomputation
    spec = _stochastic_spec()
    x = np.random.default_rng(2).standard_normal((2, *spec.patch_size, 1)).astype(np.float32)
    loss0, grads0, bufs0, gen0 = _grads_and_stats(spec, False, x, 3)
    loss1, grads1, bufs1, gen1 = _grads_and_stats(spec, remat, x, 3)
    assert torch.equal(loss0, loss1) and torch.equal(gen0, gen1)
    for g0, g1 in zip(grads0, grads1):
        assert (g0 is None) == (g1 is None)
        if g0 is not None:
            torch.testing.assert_close(g1, g0, rtol=0, atol=0)
    changed = 0
    for name, b0 in bufs0.items():
        torch.testing.assert_close(bufs1[name], b0, rtol=0, atol=0, msg=name)
        changed += name.endswith("running_var") and not torch.all(b0 == 1)
    assert changed > 20


def test_remat_flags_match_jax():
    from nextou_tpu.models.nextou import _remat_flags

    for name in ("flagship_3d_spec", "small_3d_spec"):
        spec, jspec = getattr(presets, name)(), getattr(jax_presets, name)()
        for mode in (False, True, "big"):
            assert remat_flags(spec, mode) == _remat_flags(jspec, mode)
    with pytest.raises(ValueError):
        remat_flags(presets.small_3d_spec(), "some")


# --- the slice as a whole ------------------------------------------------------------------


def _port_tree(state, template, jspec):
    """The port's parameters, BatchNorm statistics and momentum as
    ``nextou_tpu`` trees."""
    sd = state.model.state_dict()
    variables = torch_state_dict_to_variables(sd, template, jspec)
    moment = torch_state_dict_to_variables({**sd, **state.named_momentum()}, template, jspec)
    return variables["params"], variables["batch_stats"], moment["params"]


def _assert_trees_close(got, want, rtol, atol, max_off, what):
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    n = off = 0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g, w = np.asarray(flat_got[path]), np.asarray(w)
        assert g.shape == w.shape and np.isfinite(g).all(), (what, path)
        off += np.sum(np.abs(g - w) > atol + rtol * np.abs(w))
        n += w.size
    assert off / n <= max_off, f"{what}: {off} of {n} values off"


def _tiny_spec_kwargs():
    """A five-stage 3D NexToU (one conv stage, four hybrid ones, a (2, 4, 4)
    bottleneck window) whose forward holds ~2,000 kNN rows."""
    return dict(
        in_channels=1, patch_size=(8, 16, 16), n_stages=5,
        features_per_stage=[4, 6, 6, 6, 6], kernel_sizes=[(3, 3, 3)] * 5,
        strides=[(1, 1, 1), (2, 2, 2), (2, 2, 2), (1, 1, 1), (1, 1, 1)],
        n_conv_per_stage=[2] * 5, n_conv_per_stage_decoder=[2] * 4,
        num_classes=3, deep_supervision=True,
    )


def _two_pass_batch_variance(monkeypatch):
    """flax's BatchNorm takes the batch variance as ``E[x^2] - E[x]^2`` by
    default. In f32 that cancellation costs the gradient of a whole network
    about 1% by the third step (the port's f32 gradient norm stays within
    5e-4 of its own f64 one, measured on the tiny spec below). With this the
    reference runs with the two-pass variance, so that the comparison is of
    the train step and not of that rounding; nothing in ``nextou_tpu``
    changes."""
    import flax.linen.normalization as fn_norm

    compute_stats = fn_norm._compute_stats

    def two_pass(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    monkeypatch.setattr(fn_norm, "_compute_stats", two_pass)


# "tiny": few enough kNN rows that no selection is a near tie with this seed
# (the smallest gap between the k-th and the next distance is 2e-5 over the
# three steps, f32 noise ~1e-6). Every step is compared in full: loss,
# gradient norm, and parameters, momentum and BatchNorm statistics after it.
# The gradient of this network amplifies a difference in the parameters about
# a thousandfold (a relative 1e-6 moves the port's own gradient norm by 6e-4),
# so two free-running f32 trajectories part by percents within two steps;
# after each step the port is therefore set to the reference's state, through
# ``compat``, and the next step starts from the same point in both.
# "tiny_as_shipped": the same three steps against the reference exactly as it
# ships, with flax's one-pass batch variance, at the tolerances its rounding
# leaves (see ``_two_pass_batch_variance``): the gradient norm is off by 7e-5,
# 1.1e-3 and 1.3e-2 in the three steps and the loss by 7e-6 at most; at the
# widths below 0.3% of the parameters and 1.4% of the momentum lie outside
# after the third step, and the BatchNorm statistics hold the tight widths.
# "small_3d": ~1e5 rows per forward always hold a few near ties, and with
# batch statistics a row that selects another neighbour moves every gradient
# (the norm by tens of percent). It runs free, and what is compared is what a
# flipped row barely moves: the losses and the eval statistics.
#
# Per size: rtol of the loss and of the gradient norm (None: finite only),
# then (rtol, atol, share of values allowed outside) for the parameters, the
# BatchNorm statistics and the momentum after each step (None: not compared).
_STEP_TOLERANCES = {
    # f32 sums in another order, then one step of that noise through
    # lr * (clipped gradient + momentum)
    "tiny": (1e-4, 1e-3, (1e-3, 1e-5, 1e-3), (1e-3, 1e-5, 1e-3), (1e-2, 1e-4, 1e-2)),
    "tiny_as_shipped": (1e-4, 3e-2, (1e-2, 1e-4, 1e-2), (1e-3, 1e-5, 1e-3), (1e-1, 1e-3, 5e-2)),
    # with near ties a few rows select another neighbour and the loss moves
    # in its fourth digit (3.5e-4 at most in these three steps)
    "small_3d": (2e-3, None, None, None, None),
}


@pytest.mark.parametrize("size", list(_STEP_TOLERANCES))
def test_three_train_steps_and_eval_match_jax(size, monkeypatch):
    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "0")  # JAX kNN: plain path
    if size != "tiny_as_shipped":
        _two_pass_batch_variance(monkeypatch)
    if size.startswith("tiny"):
        jspec, spec = jax_build_model_spec(**_tiny_spec_kwargs()), build_model_spec(**_tiny_spec_kwargs())
        assert dataclasses.asdict(jspec) == dataclasses.asdict(spec)
    else:
        jspec = jax_presets.small_3d_spec(deep_supervision=True)
        spec = presets.small_3d_spec(deep_supervision=True)
    tight = size.startswith("tiny")
    loss_rtol, norm_rtol, params_tol, stats_tol, moment_tol = _STEP_TOLERANCES[size]
    n_out = len(spec.decoder)
    rng = np.random.default_rng(4)
    batches = [
        {"data": rng.standard_normal((2, *spec.patch_size, 1)).astype(np.float32),
         "seg": rng.integers(0, 3, (2, *spec.patch_size)).astype(np.int32)}
        for _ in range(3)
    ]
    sched = dict(initial_lr=1e-2, max_steps=1000, exponent=0.9, steps_per_epoch=250)
    ti = (3, 26, [], [[1, 2]])
    jloss = jl.CompoundLossSpec(weight_ti=1e-4, ti=jl.TILossSpec.create(*ti))
    ploss = pl.CompoundLossSpec(weight_ti=1e-4, ti=pl.TILossSpec.create(*ti))
    weights = pl.deep_supervision_weights(n_out)

    jmodel = JaxNexToU(spec=jspec, dtype=jnp.float32)
    jopt = jt.make_optimizer(jt.poly_lr(**sched))
    jstate = jt.create_train_state(jmodel, jopt, jnp.asarray(batches[0]["data"][:1]), 5)
    template = jstate.model_variables()
    start = randomized(template, 5)
    # a train state part-way: momentum and step are not at their start values
    moment0 = jax.tree_util.tree_map(lambda p: 0.01 * np.asarray(p), start["params"])
    opt_state = tuple(
        s._replace(trace=moment0) if "trace" in s._fields
        else s._replace(count=jnp.asarray(300, jnp.int32)) if "count" in s._fields else s
        for s in jstate.opt_state
    )
    jstate = jstate.replace(
        params=start["params"], batch_stats=start["batch_stats"],
        opt_state=opt_state, step=jnp.asarray(300, jnp.int32),
    )

    model = NexToU(spec)
    opt = pt.make_optimizer(pt.poly_lr(**sched))
    state = pt.create_train_state(model, opt, 0)
    load_train_state(state, start, moment0, 300, spec)
    assert state.step == 300

    jstep = jt.make_train_step(jmodel, jopt, jloss, weights)
    step = pt.make_train_step(model, opt, ploss, weights)
    for i, batch in enumerate(batches):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        jstate, want = jstep(jstate, jbatch)
        state, got = step(state, batch)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                                   rtol=loss_rtol, err_msg=f"loss, step {i}")
        assert torch.isfinite(got["grad_norm"])
        if tight:
            np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]),
                                       rtol=norm_rtol, err_msg=f"grad_norm, step {i}")
            params, stats, moment = _port_tree(state, template, jspec)
            trace = next(s for s in jstate.opt_state if "trace" in s._fields).trace
            _assert_trees_close(params, jstate.params, *params_tol, f"parameters, step {i}")
            _assert_trees_close(stats, jstate.batch_stats, *stats_tol, f"BatchNorm statistics, step {i}")
            _assert_trees_close(moment, trace, *moment_tol, f"momentum, step {i}")
            as_numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
            variables = {"params": as_numpy(jstate.params), "constants": start["constants"],
                         "batch_stats": as_numpy(jstate.batch_stats)}
            load_train_state(state, variables, as_numpy(trace), int(jstate.step), spec)
    assert state.step == 303 == int(jstate.step)

    jeval = jt.make_eval_step(jmodel, jloss, weights)(jstate, jbatch)
    peval = pt.make_eval_step(model, ploss, weights)(state, batches[-1])
    np.testing.assert_allclose(peval["loss"].item(), float(jeval["loss"]), rtol=1e-3 if tight else 1e-2)
    total = np.prod(batches[-1]["seg"].shape)
    for key in ("tp", "fp", "fn"):
        assert peval[key].dtype == torch.int64 and peval[key].shape == (2,)
        # a voxel whose two best logits nearly tie may flip: 0.1% of the
        # voxels; on small_3d the two trajectories have parted by now: 2%
        # (0.5% here, and the loss by 9e-4)
        off = np.abs(peval[key].numpy() - np.asarray(jeval[key])).max()
        assert off <= (1e-3 if tight else 2e-2) * total, (key, off, total)
    if tight:
        np.testing.assert_allclose(
            pt.pseudo_dice(peval["tp"], peval["fp"], peval["fn"]).numpy(),
            np.asarray(jt.train_step.pseudo_dice(jeval["tp"], jeval["fp"], jeval["fn"])),
            atol=2e-3,
        )


def test_eval_step_ignore_label_regions_and_pseudo_dice():
    spec = presets.small_3d_spec(features=(4, 6, 6, 6, 6, 6), deep_supervision=False)
    model = NexToU(spec)
    state = pt.create_train_state(model, pt.make_optimizer(), 1)
    rng = np.random.default_rng(6)
    batch = {"data": rng.standard_normal((1, *spec.patch_size, 1)).astype(np.float32),
             "seg": rng.integers(0, 4, (1, *spec.patch_size))}  # 3 = ignore
    with torch.no_grad():
        pred = model.eval()(torch.from_numpy(batch["data"])).argmax(-1).numpy()
    seg, valid = batch["seg"], batch["seg"] != 3

    out = pt.make_eval_step(model, pl.CompoundLossSpec(ignore_label=3))(state, batch)
    for c in (1, 2):
        assert out["tp"][c - 1] == np.sum((pred == c) & (seg == c) & valid)
        assert out["fp"][c - 1] == np.sum((pred == c) & (seg != c) & valid)
        assert out["fn"][c - 1] == np.sum((pred != c) & (seg == c) & valid)
    assert torch.isfinite(out["loss"])

    regions = ((1, 2), (2,), (1,))
    out = pt.make_eval_step(model, pl.CompoundLossSpec(regions=regions, ignore_label=3))(state, batch)
    assert out["tp"].shape == (3,)
    assert (out["tp"] + out["fn"]).tolist() == [
        int(np.sum(np.isin(seg, r) & valid)) for r in regions
    ]

    dice = pt.pseudo_dice(torch.tensor([3, 0]), torch.tensor([1, 0]), torch.tensor([1, 0]))
    assert dice[0] == 0.75 and torch.isnan(dice[1])


def test_train_state_saves_and_restores(tmp_path):
    spec = presets.small_3d_spec(features=(4, 6, 6, 6, 6, 6))
    rng = np.random.default_rng(7)
    batch = {"data": rng.standard_normal((2, *spec.patch_size, 1)).astype(np.float32),
             "seg": rng.integers(0, 3, (2, *spec.patch_size))}
    opt = pt.make_optimizer(1e-2)

    def fresh(seed):
        model = NexToU(spec)
        return pt.create_train_state(model, opt, seed), pt.make_train_step(
            model, opt, pl.CompoundLossSpec(), pl.deep_supervision_weights(5))

    state, step = fresh(0)
    state, _ = step(state, batch)
    torch.save(state.state_dict(), tmp_path / "state.pt")
    state, want = step(state, batch)

    other, other_step = fresh(9)
    other.load_state_dict(torch.load(tmp_path / "state.pt"))
    assert other.step == 1
    assert torch.equal(other.model.generator.get_state(), torch.load(tmp_path / "state.pt")["generator"])
    other, got = other_step(other, batch)
    assert torch.equal(got["loss"], want["loss"]) and torch.equal(got["grad_norm"], want["grad_norm"])
    for (name, a), b in zip(state.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), name
    for a, b in zip(state.momentum, other.momentum):
        assert torch.equal(a, b)


def test_eval_step_with_the_conv_kernel_on_matches_off(monkeypatch):
    """Eval mode on the tiny network, every (3, 3, 3) conv through the conv
    kernel's path (on the CPU its plain version): the loss within rtol 1e-5
    of the library convs' (measured 1.4e-6), the hard-Dice statistics equal."""
    from nextou_tpu_torch.nn import conv_blocks

    monkeypatch.setattr(conv_blocks, "conv_kernel_wins",
                        lambda sp, c, co, kernel, stride: tuple(kernel) == (3, 3, 3))
    spec = build_model_spec(**_tiny_spec_kwargs())
    rng = np.random.default_rng(6)
    batch = {"data": rng.standard_normal((2, *spec.patch_size, 1)).astype(np.float32),
             "seg": rng.integers(0, 3, (2, *spec.patch_size))}
    weights = pl.deep_supervision_weights(len(spec.decoder))
    out = {}
    for mode in ("0", "1"):
        model = NexToU(spec, conv_kernel=mode)
        state = pt.create_train_state(model, pt.make_optimizer(), 2)
        out[mode] = pt.make_eval_step(model, pl.CompoundLossSpec(), weights)(state, batch)
    np.testing.assert_allclose(out["1"]["loss"].item(), out["0"]["loss"].item(), rtol=1e-5)
    for key in ("tp", "fp", "fn"):
        assert torch.equal(out["1"][key], out["0"][key]), key
