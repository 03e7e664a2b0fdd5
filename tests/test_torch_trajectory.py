"""The port's training held against ``nextou_tpu``'s over a run, on the CPU in
f32: the trainers in lockstep over three epochs, and a free-running
trajectory of 40 steps beside the reference's own noise floor.

Both run the network of ``tests/test_torch_train.py::_tiny_spec_kwargs``
(about 2,000 kNN rows per forward), built by each trainer from the plans
below. The reference runs as in ``tests/test_torch_train.py``: flax
BatchNorm with the two-pass variance, its plain kNN path
(``NEXTOU_PALLAS_INTERPRET=0``) and one loader thread, so that both
trainers draw the same augmented batches (asserted bit for bit at every
step).

**Lockstep.** The JAX trainer runs 3 epochs x 4 iterations with host
augmentation, from its own initial state with the He-normal kernels halved
(as ``tests/test_torch_trainer.py`` does); every step's state, batch and
metrics are kept. The port's trainer then runs the same epochs from that
state, and before each of its steps is set to the reference's state before
that step (``compat.load_train_state``): its run goes through its own loop,
loader, schedule, eval steps, EMA and log, while every step starts where
the reference's did. Per step: the batch, the learning rate (each trainer's,
read from its update, against the poly value of the epoch), the loss, the
gradient norm, the update, the momentum, the BatchNorm statistics, and for
the TI/BTI trainer the TI term alone (the port's logits through both
packages' deep-supervised TI loss: with lambda 1e-6 in 3D the term is
invisible in the loss). Per epoch: every eval batch and its loss and
statistics, the log entry's losses, pseudo-Dice and EMA.

The per-step widths: ``_STEP_TOLERANCES["tiny"]``'s loss (1e-4) and
gradient norm (1e-3) relative, and its share of BatchNorm statistics
outside rtol 1e-3 / atol 1e-5 (1e-3); the update and the momentum within 1%
of the reference's in L2 (at the sound steps they read 0.5% at most). Its
shares of parameters and momentum are not used: with updates of 1e-2 x the
gradient, a handful of small values decides them, and they exceed their
1e-3 and 1e-2 at steps whose update is within 0.5% in L2; the update's L2
is the stricter check of a step. The rate each trainer applied is read from
its update and held to the epoch's poly value within 1e-5, so an update of
the right direction at the wrong rate fails there.

Why the widths also have floors: this network's gradient is discontinuous
wherever two of a max's k neighbours, or a selection's k-th and (k+1)-th
distances, are near equal, and at this density some steps lie on such a
tie. A quantity therefore passes within max(width, 1.5 x floor), the floor
being the step's own noise, found in up to two tiers:

1. Where a quantity lies beyond its width, the reference runs the step
   again from its state with the parameters scaled by 1 +- 1e-7 and
   1 +- 1e-6; the floor is the largest distance of those four results
   from the reference's. Where a quantity lies beyond both its width and
   1.5 x that floor, the port's side runs the same four (the tie may lie
   on its side) and its floor joins.
2. A uniform scaling cannot reach a tie behind a BatchNorm, which undoes
   it. Where a quantity is still beyond, both sides run the step again
   with each parameter value scaled by 1 + 1e-6 or 1 - 1e-6 at random (four
   draws), and those floors join. At most 3 of a trainer's 12 steps may
   pass only there.

Measured with the port in one torch thread (the test's setting): at 14 of
the 24 steps every quantity lies within its width (the update within 0.5%).
Tier 1 explains 8 others: both trainers' step 0 (update 5.1%, the
reference's floor 4.0%), the plain trainer's step 7 (a selection that
flips one ulp away: update 41%, floor 41%), and the BTI trainer's steps 2,
3 and 7 (gradient norm 1.2e-3, 1.5e-3 and 6.0e-3 off; floors 2.3e-2,
1.8e-2 and 5.2e-3), step 1 (update 3.8%, the port's floor 3.8%) and step
11 (gradient norm 12%, floor 12%). Tier 2 takes the plain trainer's steps 9
and 10 (gradient norm 1.5e-3 and 2.5e-3 off; the port's random floor
4.1e-3 and 2.4e-3, the reference's 9.1e-4 at step 9, where the uniform
floors read 2.2e-4 and less).
"""

import copy
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextou_tpu import losses as jl
from nextou_tpu import train as jt
from nextou_tpu.data import make_synthetic_dataset
from nextou_tpu.models import NexToU as JaxNexToU
from nextou_tpu.models.spec import build_model_spec as jax_build_model_spec
from nextou_tpu.train import get_trainer_class as jax_trainer_class
from nextou_tpu_torch import losses as pl
from nextou_tpu_torch import train as pt
from nextou_tpu_torch.compat import load_train_state
from nextou_tpu_torch.models import NexToU
from nextou_tpu_torch.models.spec import build_model_spec
from nextou_tpu_torch.train import get_trainer_class
from tests.test_torch_train import _port_tree, _tiny_spec_kwargs, _two_pass_batch_variance

CONFIG = "3d_tiny"
# the plans of _tiny_spec_kwargs' network: 5 stages of 4/6/6/6/6 features,
# strides 1/2/2/1/1, a (8, 16, 16) patch
PLANS = {
    "dataset_name": "Dataset996_Tiny3d", "plans_name": "nnUNetPlans",
    "configurations": {CONFIG: {
        "batch_size": 2, "patch_size": [8, 16, 16], "spacing": [1.0, 1.0, 1.0],
        "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
        "UNet_class_name": "PlainConvUNet", "UNet_base_num_features": 4,
        "unet_max_num_features": 6, "n_conv_per_stage_encoder": [2] * 5,
        "n_conv_per_stage_decoder": [2] * 4,
        "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2], [2, 2, 2], [1, 1, 1], [1, 1, 1]],
        "conv_kernel_sizes": [[3, 3, 3]] * 5, "batch_dice": True,
    }},
}
DATASET_JSON = {"labels": {"background": 0, "a": 1, "b": 2}, "numTraining": 6,
                "channel_names": {"0": "img"}}
EPOCHS, ITERS, VAL_ITERS = 3, 4, 2
# the perturbations of a step's starting parameters that measure its noise
# floor, (eps, seed): every parameter scaled by 1 + eps where seed is None,
# else each value by 1 + eps or 1 - eps at random. BatchNorm absorbs a
# uniform scaling of the kernels before it, so the second kind, which
# moves the forward of the layers under a BatchNorm too, finds near ties
# that the first cannot (see the module docstring)
FLOOR_RUNS = ((1e-7, None), (-1e-7, None), (1e-6, None), (-1e-6, None))
RANDOM_RUNS = ((1e-6, 0), (1e-6, 1), (1e-6, 2), (1e-6, 3))
# the most steps of a trainer's 12 that may pass only within the random floor
MAX_RANDOM_FLOOR_STEPS = 3
# quantity -> fixed width: _STEP_TOLERANCES["tiny"]'s loss and gradient
# norm (relative) and share of BatchNorm statistics outside rtol 1e-3 /
# atol 1e-5; the update and the momentum within 1% of the reference's in L2
WIDTHS = {"loss": 1e-4, "grad_norm": 1e-3, "update": 1e-2, "momentum": 1e-2, "stats": 1e-3}


def write_dataset(folder: str) -> str:
    """Six synthetic 16 x 32 x 32 cases with the plans and dataset.json."""
    make_synthetic_dataset(folder, n_cases=6, shape=(16, 32, 32), num_classes=3)
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(PLANS, f)
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump(DATASET_JSON, f)
    return folder


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return write_dataset(str(tmp_path_factory.mktemp("tiny3d")))


def reference_settings(monkeypatch):
    """The reference as the port's step tests run it."""
    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "0")  # plain kNN path
    monkeypatch.setenv("NEXTOU_LOADER_THREADS", "1")  # bit-equal batches
    _two_pass_batch_variance(monkeypatch)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side in one thread: this network's tensors are small, and
    the tests run beside others on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def reference(monkeypatch):
    reference_settings(monkeypatch)
    return monkeypatch


def make_jax_trainer(name, folder, out, monkeypatch, **kw):
    """The JAX trainer of ``name`` on ``folder``, initialized on one device
    (the tests' eight virtual CPU devices would shard its batch), holding its
    initial state with the kernels halved (as tests/test_torch_trainer.py:
    the full-scale initial network puts kNN selections of the first steps on
    near ties)."""
    with monkeypatch.context() as m:
        m.setattr(jax, "device_count", lambda: 1)
        jax_t = jax_trainer_class(name)(
            PLANS, CONFIG, 0, DATASET_JSON, preprocessed_folder=folder, output_folder=out,
            compute_dtype=jnp.float32, num_val_iterations_per_epoch=VAL_ITERS, remat=False,
            device_da=False, **kw)
        jax_t.initialize()
    assert jax_t.mesh is None
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) * (0.5 if path[-1].key == "kernel" else 1.0),
        jax.device_get(jax_t.state.model_variables()))
    jax_t.state = jax_t.state.replace(params=variables["params"])
    return jax_t


def make_port_trainer(name, folder, out, **kw):
    port_t = get_trainer_class(name)(
        PLANS, CONFIG, 0, DATASET_JSON, preprocessed_folder=folder, output_folder=out,
        device="cpu", loader_threads=1, remat=False, device_da=False, **kw).initialize()
    port_t.num_val_iterations_per_epoch = VAL_ITERS
    assert dataclasses.asdict(port_t.model_spec) == dataclasses.asdict(
        build_model_spec(**_tiny_spec_kwargs()))
    return port_t


def trace_of(state):
    return next(s for s in state.opt_state if "trace" in s._fields).trace


def set_port_state(port_t, jstate):
    """The port's train state set to a (host) reference state."""
    as_numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    load_train_state(port_t.state, as_numpy(jstate.model_variables()), as_numpy(trace_of(jstate)),
                     int(jstate.step), port_t.model_spec)


def leaves(tree) -> dict:
    return {path: np.asarray(v, np.float64)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def l2_off(got, want, base=None) -> float:
    """||got - want|| / ||want - base|| over a whole tree (base 0 if None)."""
    got, want = leaves(got), leaves(want)
    base = leaves(base) if base is not None else {p: 0.0 for p in want}
    num = sum(np.sum((got[p] - w) ** 2) for p, w in want.items())
    den = sum(np.sum((w - base[p]) ** 2) for p, w in want.items())
    return float(np.sqrt(num / den))


def share_off(got, want, rtol=1e-3, atol=1e-5) -> float:
    got, want = leaves(got), leaves(want)
    off = sum(np.sum(np.abs(got[p] - w) > atol + rtol * np.abs(w)) for p, w in want.items())
    return off / sum(w.size for w in want.values())


def effective_lr(before, after, momentum_before, momentum_after, mu=0.99) -> float:
    """The rate a Nesterov SGD update applied: with m' = mu m + g, the step
    is -lr (g + mu m'), so lr = -<dp, u> / <u, u> over every parameter."""
    p0, p1, m0, m1 = (leaves(t) for t in (before, after, momentum_before, momentum_after))
    u = {k: (m1[k] - mu * m0[k]) + mu * m1[k] for k in p0}
    return -sum(np.sum((p1[k] - p0[k]) * u[k]) for k in p0) / sum(np.sum(u[k] ** 2) for k in p0)


def poly(epoch: int) -> float:
    return 1e-2 * (1 - epoch / EPOCHS) ** 0.9


def distances(got, want, before) -> dict:
    """Each quantity of the step result ``got`` against ``want``: results are
    (loss, gradient norm, parameters, BatchNorm statistics, momentum) as
    ``nextou_tpu`` trees, both from the parameters ``before``."""
    return {
        "loss": abs(got[0] / want[0] - 1),
        "grad_norm": abs(got[1] / want[1] - 1),
        "update": l2_off(got[2], want[2], before),
        "momentum": l2_off(got[4], want[4]),
        "stats": share_off(got[3], want[3]),
    }


def perturbed(params, eps: float, seed: int | None):
    """``params`` scaled as :data:`FLOOR_RUNS` says (host numpy trees)."""
    rng = None if seed is None else np.random.default_rng(seed)

    def scale(a):
        a = np.asarray(a)
        factor = 1 + eps if rng is None else 1 + eps * rng.choice([-1.0, 1.0], a.shape)
        return (a * factor).astype(a.dtype)

    return jax.tree_util.tree_map(scale, params)


def reference_result(state, loss, grad_norm) -> tuple:
    return loss, grad_norm, state.params, state.batch_stats, trace_of(state)


def record_reference(jax_t):
    """Wrap the JAX trainer's steps: each train step keeps its state before
    and after (host copies), its batch and its metrics; each eval step its
    batch and outputs."""
    steps, evals = [], []
    train_step, eval_step = jax_t.train_step, jax_t.eval_step

    def recorded_train_step(state, batch):
        before = jax.device_get(state)
        state, metrics = train_step(state, batch)
        after = jax.device_get(state)
        steps.append({"before": before, "after": after,
                      "batch": {k: np.asarray(v) for k, v in batch.items()},
                      "result": reference_result(after, float(metrics["loss"]),
                                                 float(metrics["grad_norm"]))})
        return state, metrics

    def recorded_eval_step(state, batch):
        out = eval_step(state, batch)
        evals.append(({k: np.asarray(v) for k, v in batch.items()},
                      {k: np.asarray(v) for k, v in out.items()}))
        return out

    jax_t.train_step, jax_t.eval_step = recorded_train_step, recorded_eval_step
    return steps, evals, train_step


def reference_run(name, folder, out, monkeypatch) -> dict:
    """The JAX trainer's run of ``EPOCHS`` x ``ITERS``, every step recorded
    (:func:`record_reference`). Its ``checkpoint_latest.ckpt`` after epoch 0
    is kept in ``out/fold`` as a fold that ``nextou_tpu`` began."""
    jax_t = make_jax_trainer(name, folder, os.path.join(out, "jax"), monkeypatch,
                             num_epochs=EPOCHS, num_iterations_per_epoch=ITERS)
    steps, evals, train_step = record_reference(jax_t)
    fold = os.path.join(out, "fold")
    os.makedirs(fold)
    save = jax_t.save_checkpoint
    jax_t.checkpoint_every = 1

    def save_keeping_epoch_0(ckpt: str):
        save(ckpt)
        if ckpt == "checkpoint_latest.ckpt" and jax_t.current_epoch == 0:
            shutil.copy(os.path.join(jax_t.output_folder, ckpt), fold)

    jax_t.save_checkpoint = save_keeping_epoch_0
    jax_t.run_training()
    assert len(steps) == EPOCHS * ITERS and len(evals) == EPOCHS * VAL_ITERS
    return {"trainer": jax_t, "train_step": train_step, "steps": steps, "evals": evals,
            "log": copy.deepcopy(jax_t.log_history), "best_ema": jax_t._best_ema, "fold": fold}


@pytest.fixture(scope="module")
def reference_runs(dataset, tmp_path_factory):
    """Each trainer's reference run, made once: the JAX step's compilation
    is most of a run's time, and the resume test reads the BTI run's fold."""
    runs = {}

    def get(name):
        if name not in runs:
            with pytest.MonkeyPatch.context() as monkeypatch:
                reference_settings(monkeypatch)
                runs[name] = reference_run(name, dataset, str(tmp_path_factory.mktemp("ref")),
                                           monkeypatch)
        return runs[name]

    return get


def port_result(port_t, state, metrics, template) -> tuple:
    """The port's step result as host copies of ``nextou_tpu`` trees (the
    trees that ``_port_tree`` returns share the model's memory)."""
    trees = jax.tree_util.tree_map(np.array, _port_tree(state, template, port_t.model_spec))
    return (metrics["loss"].item(), metrics["grad_norm"].item(), *trees)


def port_floor(port_t, train_step, ref, batch, result, runs=FLOOR_RUNS) -> dict:
    """The port's own floor at a step: its results from the reference's state
    before the step with the parameters perturbed as ``runs`` say, against
    its result ``result`` from that state itself."""
    floors = []
    template = ref["after"].model_variables()
    for eps, seed in runs:
        before = ref["before"]
        set_port_state(port_t, before.replace(params=perturbed(before.params, eps, seed)))
        state, m = train_step(port_t.state, batch)
        floors.append(distances(port_result(port_t, state, m, template), result,
                                before.params))
    return {k: max(f[k] for f in floors) for k in WIDTHS}


def reference_floor(train_step, ref, runs) -> dict:
    """The reference's floor at a step: its results from its state before
    the step with the parameters perturbed as ``runs`` say, against its
    result from that state itself."""
    batch = {k: jnp.asarray(v) for k, v in ref["batch"].items()}
    floors = []
    for eps, seed in runs:
        before = ref["before"]
        start = jax.tree_util.tree_map(
            jnp.asarray, before.replace(params=perturbed(before.params, eps, seed)))
        new, m = train_step(start, batch)
        other = reference_result(jax.device_get(new), float(m["loss"]), float(m["grad_norm"]))
        floors.append(distances(other, ref["result"], before.params))
    return {k: max(f[k] for f in floors) for k in WIDTHS}


def ti_terms(logits, seg, port_t, jax_t) -> tuple[float, float]:
    """The deep-supervised TI/BTI term (without lambda) of the same logits
    through each package's loss."""
    seg = torch.as_tensor(seg).long()
    got = pl.deep_supervised_loss(
        logits, seg, lambda o, t: pl.ti_loss(o, t, port_t.loss_spec.ti), port_t.ds_weights)
    want = jl.deep_supervised_loss(
        [jnp.asarray(o.numpy()) for o in logits], jnp.asarray(seg.numpy()),
        lambda o, t: jl.ti_loss(o, t, jax_t.loss_spec.ti), jax_t.ds_weights)
    return got.item(), float(want)


@pytest.mark.parametrize("name", ["nnUNetTrainer_NexToU", "nnUNetTrainer_NexToU_BTI_RAVIR"])
def test_trainers_in_lockstep_over_three_epochs(name, dataset, tmp_path, reference_runs):
    run = reference_runs(name)
    jax_t, steps, evals = run["trainer"], run["steps"], run["evals"]
    port_t = make_port_trainer(name, dataset, str(tmp_path), num_epochs=EPOCHS,
                               num_iterations_per_epoch=ITERS)
    ti = port_t.loss_spec.weight_ti > 0
    assert ti == (name != "nnUNetTrainer_NexToU")

    logits, rows, random_floor_steps = [], [], []
    port_t.network.register_forward_hook(lambda mod, args, out: logits.append(
        [o.detach() for o in out]))
    train_step, eval_step = port_t.train_step, port_t.eval_step

    def lockstep_train_step(state, batch):
        i = len(rows)
        ref = steps[i]
        for key in ("data", "seg"):
            np.testing.assert_array_equal(np.asarray(batch[key]), ref["batch"][key], err_msg=key)
        set_port_state(port_t, ref["before"])
        logits.clear()
        state, metrics = train_step(state, batch)
        result = port_result(port_t, state, metrics, ref["after"].model_variables())
        params, momentum = result[2], result[4]
        got = distances(result, ref["result"], ref["before"].params)
        # the floors, tier by tier, only as far as a quantity lies beyond
        floor = dict.fromkeys(WIDTHS, 0.0)
        tiers = (lambda: [reference_floor(run["train_step"], ref, FLOOR_RUNS)],
                 # the tie may lie on the port's side
                 lambda: [port_floor(port_t, train_step, ref, batch, result)],
                 # a tie that a uniform scaling cannot reach, on either side
                 lambda: [reference_floor(run["train_step"], ref, RANDOM_RUNS),
                          port_floor(port_t, train_step, ref, batch, result, RANDOM_RUNS)])
        for tier, floors in enumerate(tiers):
            if all(got[k] <= max(w, 1.5 * floor[k]) for k, w in WIDTHS.items()):
                break
            for more in floors():
                floor = {k: max(floor[k], more[k]) for k in WIDTHS}
            if tier == 2:
                random_floor_steps.append(i)
        for key, width in WIDTHS.items():
            assert got[key] <= max(width, 1.5 * floor[key]), (
                f"step {i}: {key} off by {got[key]:.3g}, the floor {floor[key]:.3g}")
        epoch = i // ITERS
        lrs = (effective_lr(ref["before"].params, params, trace_of(ref["before"]), momentum),
               effective_lr(ref["before"].params, ref["after"].params, trace_of(ref["before"]),
                            trace_of(ref["after"])))
        np.testing.assert_allclose(lrs, poly(epoch), rtol=1e-5, err_msg=f"learning rate, step {i}")
        if ti:
            term, want = ti_terms(logits[0], batch["seg"], port_t, jax_t)
            assert term > 0, f"step {i}: no critical voxel"
            np.testing.assert_allclose(term, want, rtol=1e-4, err_msg=f"TI term, step {i}")
        rows.append({"loss": result[0], "floor": floor["loss"]})
        # the next step (or the epoch's eval) starts from the reference's state
        set_port_state(port_t, ref["after"])
        return state, metrics

    n_eval = []

    def lockstep_eval_step(state, batch):
        want_batch, want = evals[len(n_eval)]
        n_eval.append(1)
        for key in ("data", "seg"):
            np.testing.assert_array_equal(np.asarray(batch[key]), want_batch[key], err_msg=key)
        out = eval_step(state, batch)
        np.testing.assert_allclose(out["loss"].item(), want["loss"], rtol=1e-4)
        total = np.prod(want_batch["seg"].shape)
        for key in ("tp", "fp", "fn"):
            assert np.abs(out[key].numpy() - want[key]).max() <= 1e-3 * total, key
        return out

    port_t.train_step, port_t.eval_step = lockstep_train_step, lockstep_eval_step
    port_t.run_training()
    assert len(rows) == EPOCHS * ITERS and len(n_eval) == EPOCHS * VAL_ITERS
    assert len(random_floor_steps) <= MAX_RANDOM_FLOOR_STEPS, random_floor_steps
    assert port_t.state.step == EPOCHS * ITERS == int(steps[-1]["after"].step)

    assert len(port_t.log_history) == len(run["log"]) == EPOCHS
    for epoch, (got, want) in enumerate(zip(port_t.log_history, run["log"])):
        assert got["epoch"] == want["epoch"] == epoch
        losses = [r["loss"] for r in rows[epoch * ITERS:(epoch + 1) * ITERS]]
        np.testing.assert_allclose(got["train_loss"], np.mean(losses), rtol=1e-6)
        assert got["first_step_loss"] == pytest.approx(losses[0], rel=1e-6)
        floor = max(r["floor"] for r in rows[epoch * ITERS:(epoch + 1) * ITERS])
        np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                                   rtol=max(1e-4, 1.5 * floor))
        np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-4)
        np.testing.assert_allclose(got["pseudo_dice"], want["pseudo_dice"], atol=2e-3)
        np.testing.assert_allclose(got["ema_pseudo_dice"], want["ema_pseudo_dice"], atol=2e-3)
    assert port_t._best_ema == pytest.approx(run["best_ema"], abs=2e-3)


# --- free running -------------------------------------------------------------------

FREE_STEPS = 40


def _free_batches(spec):
    """Four fixed batches, cycled (tests/test_knn_bf16_trajectory.py): a box
    of one foreground label in each sample, on noise."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(4):
        seg = np.zeros((2, *spec.patch_size), np.int32)
        for b in range(2):
            z, y, x = (int(rng.integers(0, s - 4)) for s in spec.patch_size)
            seg[b, z:z + 4, y:y + 6, x:x + 6] = rng.integers(1, spec.num_classes)
        data = seg.astype(np.float32) + 0.1 * rng.standard_normal(seg.shape).astype(np.float32)
        out.append({"data": data[..., None], "seg": seg})
    return out


def test_free_running_port_stays_within_the_noise_floor(reference):
    """40 steps of the tiny network without resets, on fixed batches, from
    the same initial state: over the second half the mean |port - JAX| loss
    stays within max(1.5 x floor, 5e-3), the floor being the mean |JAX - JAX
    with the initial parameters scaled by (1 + 1e-6)|; every trajectory
    falls by more than 0.2."""
    jspec = jax_build_model_spec(**_tiny_spec_kwargs())
    spec = build_model_spec(**_tiny_spec_kwargs())
    batches = _free_batches(spec)
    sched = dict(initial_lr=1e-2, max_steps=1000, exponent=0.9, steps_per_epoch=250)
    jmodel = JaxNexToU(spec=jspec, dtype=jnp.float32)
    jopt = jt.make_optimizer(jt.poly_lr(**sched))
    jstep = jt.make_train_step(jmodel, jopt, jl.CompoundLossSpec(),
                               jl.deep_supervision_weights(len(jspec.decoder)))
    start = jt.create_train_state(jmodel, jopt, jnp.asarray(batches[0]["data"][:1]), 0)
    start = jax.device_get(start)

    def run_jax(scale):
        state = jax.tree_util.tree_map(jnp.asarray, start)
        state = state.replace(params=jax.tree_util.tree_map(lambda a: a * scale, state.params))
        losses = []
        for i in range(FREE_STEPS):
            state, m = jstep(state, {k: jnp.asarray(v) for k, v in batches[i % 4].items()})
            losses.append(float(m["loss"]))
        return np.asarray(losses)

    model = NexToU(spec)
    opt = pt.make_optimizer(pt.poly_lr(**sched))
    state = pt.create_train_state(model, opt, 0)
    as_numpy = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    load_train_state(state, as_numpy(start.model_variables()), as_numpy(trace_of(start)), 0, spec)
    step = pt.make_train_step(model, opt, pl.CompoundLossSpec(),
                              pl.deep_supervision_weights(len(spec.decoder)))
    port = []
    for i in range(FREE_STEPS):
        state, m = step(state, batches[i % 4])
        port.append(m["loss"].item())
    port = np.asarray(port)
    ref, other = run_jax(1.0), run_jax(1.0 + 1e-6)

    np.testing.assert_allclose(port[0], ref[0], rtol=1e-4)
    for losses in (port, ref, other):
        assert np.isfinite(losses).all() and losses[-1] < losses[0] - 0.2, losses
    half = FREE_STEPS // 2
    floor = np.abs(other[half:] - ref[half:]).mean()
    off = np.abs(port[half:] - ref[half:]).mean()
    assert off <= max(1.5 * floor, 5e-3), (off, floor)


# --- resuming a nextou_tpu fold ------------------------------------------------------


def test_port_resumes_a_nextou_tpu_fold(reference_runs, dataset, tmp_path, reference):
    """A fold that the JAX trainer began goes on in the port: the BTI
    trainer's reference run kept its ``checkpoint_latest.ckpt`` of epoch 0.
    The port's trainer loads it with the epoch, best and current EMA, log,
    step, parameters, BatchNorm statistics and momentum of the JAX state,
    and its next step on the same batch gives the JAX step's loss from that
    state within rtol 1e-4; ``run_training --c`` picks the ``.ckpt`` and
    trains the next epoch; ``--val`` on a folder holding only the run's
    ``checkpoint_final.ckpt`` serves the JAX trainer's validation labels."""
    from nextou_tpu_torch import run_training

    name = "nnUNetTrainer_NexToU_BTI_RAVIR"
    run = reference_runs(name)
    jax_t, fold = run["trainer"], run["fold"]
    latest = run_training.checkpoint_path(fold, "checkpoint_latest")
    assert latest == os.path.join(fold, "checkpoint_latest.ckpt")
    port_t = make_port_trainer(name, dataset, str(tmp_path / "port"), num_epochs=EPOCHS,
                               num_iterations_per_epoch=ITERS)
    extra = port_t.load_checkpoint(latest)
    want = run["steps"][ITERS - 1]["after"]  # the state after epoch 0
    assert extra["trainer"] == name and extra["current_epoch"] == 0
    assert port_t.current_epoch == 1
    assert port_t.log_history == run["log"][:1]
    assert port_t.ema_pseudo_dice == port_t._best_ema == run["log"][0]["ema_pseudo_dice"]
    assert port_t.state.step == int(want.step) == ITERS
    params, stats, momentum = _port_tree(port_t.state, want.model_variables(), port_t.model_spec)
    for got, ref in ((params, want.params), (stats, want.batch_stats),
                     (momentum, trace_of(want))):
        for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree_util.tree_leaves(ref)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=str(path))
    assert any(np.abs(np.asarray(m)).max() > 0 for m in jax.tree_util.tree_leaves(momentum))

    # both loaders start again from the seed after a resume
    (jax_loader, _), (port_loader, _) = jax_t.get_dataloaders(), port_t.get_dataloaders()
    with jax_loader, port_loader:
        jbatch, batch = next(iter(jax_loader)), next(iter(port_loader))
    for key in ("data", "seg"):
        np.testing.assert_array_equal(batch[key], jbatch[key])
    _, jm = run["train_step"](jax.tree_util.tree_map(jnp.asarray, want),
                              {k: jnp.asarray(v) for k, v in jbatch.items()})
    _, m = port_t.train_step(port_t.state, batch)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-4)

    resumed = str(tmp_path / "resumed")
    shutil.copytree(fold, resumed)
    trainer = run_training.main([dataset, CONFIG, "0", "-tr", name, "-o", resumed, "--c",
                                 "--epochs", "2", "--iters", "1", "--device", "cpu"])
    assert trainer.state.step == ITERS + 1
    assert [e["epoch"] for e in trainer.log_history] == [0, 1]
    assert trainer.log_history[0] == run["log"][0]
    assert os.path.exists(os.path.join(resumed, "checkpoint_final.pth"))

    val_only = str(tmp_path / "val_only")
    os.makedirs(val_only)
    shutil.copy(os.path.join(jax_t.output_folder, "checkpoint_final.ckpt"), val_only)
    jax_t.perform_actual_validation()
    run_training.main([dataset, CONFIG, "0", "-tr", name, "-o", val_only, "--val",
                       "--device", "cpu"])
    cases = sorted(f for f in os.listdir(os.path.join(jax_t.output_folder, "validation"))
                   if f.endswith(".npz"))
    assert cases
    for case in cases:
        with np.load(os.path.join(val_only, "validation", case)) as a, \
                np.load(os.path.join(jax_t.output_folder, "validation", case)) as b:
            np.testing.assert_array_equal(a["seg"], b["seg"], err_msg=case)
