"""Data parallel in the port (``nextou_tpu_torch/parallel/``) on the CPU:
two ranks of one sample each against one process of two samples, and
against ``nextou_tpu``'s train step at the global batch.

The module spawns two gloo ranks once; they meet at a ``file://`` store
under a ``tmp_path`` (no port, so parallel test workers never collide). Each
rank runs with one torch thread, runs every check in turn and saves what it
saw; the parent process computes the references meanwhile and compares. Every rank's loss is the global batch's, so
its gradient is the world size times its share of the global gradient: the
loss checks divide by 2, and the train step's average over the ranks takes
the factor out (held by the step's checks).
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nextou_tpu_torch import losses as pl
from nextou_tpu_torch import train as pt
from nextou_tpu_torch.models import NexToU
from nextou_tpu_torch.models.spec import build_model_spec
from nextou_tpu_torch.nn.layers import DropPath, batch_norm
from nextou_tpu_torch.parallel import initialize_distributed, local_share, rank

WORLD = 2
GLOBAL = 4  # samples of the layer and loss checks; 2 per rank
# the loss terms under test: CompoundLossSpec's fields, and the classes
LOSS_CASES = {
    "batch_dice_ce": (dict(batch_dice=True), 4),
    "per_sample_dice_ce": (dict(batch_dice=False), 4),
    "ignore_label": (dict(ignore_label=3), 4),
    "regions_ignore_label": (dict(regions=((1, 2), (2,)), ignore_label=3), 2),
    "ti": (dict(weight_ce=0.0, weight_dice=0.0, weight_ti=1.0,
                ti=pl.TILossSpec.create(3, 26, [], [[1, 2]])), 4),
    "bti": (dict(weight_ti=1e-2, ti=pl.TILossSpec.create(
        3, 26, exclusion=[[[1, 2], [3]]], inclusion=[[1, 2]])), 4),
}
STEPS = 2


# --- the two ranks ---------------------------------------------------------------------


CHECKS = ("layers", "steps", "cli")


def _rank_main(r: int, tmp: str, dataset: str):
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(WORLD),
                      LOCAL_WORLD_SIZE=str(WORLD))
    torch.set_num_threads(1)
    initialize_distributed("cpu", init_method=f"file://{tmp}/store")
    try:
        for check in CHECKS:
            torch.save(globals()[check](r, tmp, dataset), os.path.join(tmp, f"{check}_{r}.pt"))
    finally:
        dist.destroy_process_group()


class _Ranks:
    """Two gloo ranks running every check of this file in the background
    while the parent computes its references; :meth:`result` waits for
    them."""

    def __init__(self, tmp, dataset: str, timeout: float = 240.0):
        self.tmp, self.deadline = str(tmp), time.monotonic() + timeout
        self.ctx = mp.start_processes(_rank_main, args=(self.tmp, dataset), nprocs=WORLD,
                                      join=False, start_method="spawn")

    def result(self, check: str) -> list:
        while not self.ctx.join(timeout=1.0):  # raises where a rank raised
            if time.monotonic() > self.deadline:
                for p in self.ctx.processes:
                    p.kill()
                raise TimeoutError("the ranks did not finish in time")
        return [torch.load(os.path.join(self.tmp, f"{check}_{r}.pt"), weights_only=False)
                for r in range(WORLD)]


def _share(a, r: int):
    n = a.shape[0] // WORLD
    return a[r * n:(r + 1) * n]


def _layer_inputs():
    rng = np.random.default_rng(0)
    return {
        "x": (2.0 * rng.standard_normal((GLOBAL, 5, 6, 7, 3)) + 0.5).astype(np.float32),
        # BatchNorm's cotangent, scaled so that its weight and bias
        # gradients (sums of 504 terms per channel) are O(1), where f32
        # sums in another order stay within atol 1e-6
        "g": (rng.standard_normal((GLOBAL, 5, 6, 7, 3)) / 32).astype(np.float32),
        "weight": rng.uniform(0.5, 1.5, 5).astype(np.float32),
        "bias": rng.standard_normal(5).astype(np.float32),
        "logits": rng.standard_normal((GLOBAL, 6, 7, 5, 4)).astype(np.float32),
        "target": rng.integers(0, 4, (GLOBAL, 6, 7, 5)),
        "drop": rng.standard_normal((GLOBAL, 3, 4)).astype(np.float32),
    }


def _batch_norm_run(x, g, weight, bias):
    """A BatchNorm3d in training through ``batch_norm``: its output, the
    gradients of ``sum(y * g)`` and its running statistics."""
    bn = torch.nn.BatchNorm3d(x.shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    x = torch.from_numpy(x).requires_grad_()
    y = batch_norm(bn, x)
    (y * torch.from_numpy(g)).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def _loss_run(case: str, logits, target):
    kw, classes = LOSS_CASES[case]
    logits = torch.from_numpy(np.ascontiguousarray(logits[..., :classes])).requires_grad_()
    loss = pl.dc_ce_ti_loss(logits, torch.from_numpy(target), pl.CompoundLossSpec(**kw))
    loss.backward()
    return {"loss": loss.detach(), "grad": logits.grad}


def _drop_path_run(x):
    gen = torch.Generator().manual_seed(0)
    drop = DropPath(0.5, gen).train()
    return [drop(torch.from_numpy(x)) for _ in range(3)]


def layers(r: int, tmp: str, dataset: str) -> dict:
    """The synchronized BatchNorm, every loss term and DropPath on this
    rank's share of :func:`_layer_inputs`."""
    inp = {k: _share(v, r) if k not in ("weight", "bias") else v
           for k, v in _layer_inputs().items()}
    # the sum of the ranks' sum(y * g) is the one process's: no factor
    out = {"bn": _batch_norm_run(inp["x"], inp["g"], inp["weight"], inp["bias"])}
    out.update({case: _loss_run(case, inp["logits"], inp["target"]) for case in LOSS_CASES})
    out["drop"] = _drop_path_run(inp["drop"])
    return out


def _tiny_spec():
    """``tests/test_torch_train.py::_tiny_spec_kwargs`` (a five-stage 3D
    NexToU of ~2,000 kNN rows per forward), written out so that the ranks
    import no jax."""
    return build_model_spec(
        in_channels=1, patch_size=(8, 16, 16), n_stages=5,
        features_per_stage=[4, 6, 6, 6, 6], kernel_sizes=[(3, 3, 3)] * 5,
        strides=[(1, 1, 1), (2, 2, 2), (2, 2, 2), (1, 1, 1), (1, 1, 1)],
        n_conv_per_stage=[2] * 5, n_conv_per_stage_decoder=[2] * 4,
        num_classes=3, deep_supervision=True,
    )


_SCHED = dict(initial_lr=1e-2, max_steps=1000, exponent=0.9, steps_per_epoch=250)
_TI = (3, 26, [], [[1, 2]])


def _step_run(start: dict, batch: dict, r: int | None = None,
              dtype: torch.dtype = torch.float32) -> dict:
    """One train step of the tiny network from ``start`` (a port train state
    dict), on rank ``r``'s share of ``batch`` or on all of it, in ``dtype``:
    the loss, the gradient norm and the state after it."""
    spec = _tiny_spec()
    model = NexToU(spec, dtype=dtype).to(dtype)
    opt = pt.make_optimizer(pt.poly_lr(**_SCHED))
    state = pt.create_train_state(model, opt, 0)
    state.load_state_dict(start)
    loss_spec = pl.CompoundLossSpec(weight_ti=1e-4, ti=pl.TILossSpec.create(*_TI))
    step = pt.make_train_step(model, opt, loss_spec, pl.deep_supervision_weights(len(spec.decoder)))
    if r is not None:
        batch = {k: _share(v, r) for k, v in batch.items()}
    batch = {**batch, "data": batch["data"].astype(torch.empty((), dtype=dtype).numpy().dtype)}
    state, m = step(state, batch)
    return {"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
            "state": state.state_dict()}


def steps(r: int, tmp: str, dataset: str) -> list:
    """Step ``i`` from the one process's state before it (``starts[i]``)."""
    run = torch.load(os.path.join(tmp, "starts.pt"), weights_only=False)
    return [_step_run(start, batch, r) for start, batch in zip(run["starts"], run["batches"])]


def cli(r: int, tmp: str, dataset: str) -> dict:
    """``run_training.main`` at 2d_tiny, 1 epoch x 2 iterations, with spies:
    the files this rank opens for writing, its first train batch and its
    own eval statistics; then an odd global batch."""
    from nextou_tpu_torch import run_training
    from nextou_tpu_torch.train import trainer as trainer_module

    written = []

    def audit(event, args):
        # every file this process opens for writing under the dataset folder,
        # which holds the output folder
        if event == "open" and isinstance(args[0], str) and args[0].startswith(dataset):
            mode, flags = args[1], args[2]
            if (mode and any(c in mode for c in "wax+")) or (
                    not mode and flags & (os.O_WRONLY | os.O_RDWR)):
                written.append(os.path.relpath(args[0], dataset))

    sys.addaudithook(audit)
    save_checkpoint = trainer_module.save_checkpoint  # torch.save opens its file in C++

    def spy_save(path, *a, **kw):
        written.append(os.path.relpath(path, dataset))
        return save_checkpoint(path, *a, **kw)

    trainer_module.save_checkpoint = spy_save
    seen = {"stats": 0}
    make_train_step, make_eval_step = trainer_module.make_train_step, trainer_module.make_eval_step

    def spy_train(*a, **kw):
        step = make_train_step(*a, **kw)

        def wrapped(state, batch):
            seen.setdefault("first_batch", {k: np.asarray(batch[k]) for k in ("data", "seg")})
            return step(state, batch)
        return wrapped

    def spy_eval(*a, **kw):
        step = make_eval_step(*a, **kw)

        def wrapped(state, batch):
            out = step(state, batch)
            seen["stats"] = seen["stats"] + torch.stack([out["tp"], out["fp"], out["fn"]])
            return out
        return wrapped

    trainer_module.make_train_step, trainer_module.make_eval_step = spy_train, spy_eval
    trainer = run_training.main([dataset, "2d_tiny", "0", "--epochs", "1", "--iters", "2",
                                 "--device", "cpu"])
    try:
        run_training.main([dataset, "2d_tiny", "0", "--epochs", "1", "--iters", "2",
                           "--device", "cpu", "-o", os.path.join(dataset, "odd"),
                           "--batch-size", "3"])
        odd = None
    except ValueError as e:
        odd = str(e)
    return {"written": sorted(set(written)),
            "output": os.path.relpath(trainer.output_folder, dataset),
            "first_batch": seen["first_batch"],
            "stats": seen["stats"], "log_history": trainer.log_history,
            "local_batch": trainer.local_batch_size, "odd": odd}


# --- the checks ------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The references here are small ops: one intra-op thread keeps them
    from waiting on each other's threads where pytest's workers and the two
    ranks share the cores; the results are the same."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """A 2d_tiny dataset folder (``tests/test_torch_trainer.py``'s), the
    tiny network from a seeded, randomized state part-way through training
    (``tests/test_torch_train.py``'s "tiny" case: halved He kernels, random
    norm statistics, momentum, step 300), its one-process steps on batches
    of 2, and the two ranks running every check from them in the
    background."""
    import jax
    import jax.numpy as jnp
    from nextou_tpu import train as jt
    from nextou_tpu.data import make_synthetic_dataset
    from nextou_tpu.models import NexToU as JaxNexToU
    from nextou_tpu.models.spec import build_model_spec as jax_build_model_spec
    from nextou_tpu_torch.compat import load_train_state
    from tests.test_torch_model import randomized
    from tests.test_torch_train import _tiny_spec_kwargs
    from tests.test_train_integration import DATASET_JSON, TINY_PLANS

    tmp = tmp_path_factory.mktemp("ranks")
    dataset = str(tmp_path_factory.mktemp("synth2d"))
    make_synthetic_dataset(dataset, n_cases=6, shape=(64, 64), num_classes=3)
    with open(os.path.join(dataset, "nnUNetPlans.json"), "w") as f:
        json.dump(TINY_PLANS, f)
    with open(os.path.join(dataset, "dataset.json"), "w") as f:
        json.dump(DATASET_JSON, f)

    spec, jspec = _tiny_spec(), jax_build_model_spec(**_tiny_spec_kwargs())
    assert dataclasses.asdict(spec) == dataclasses.asdict(build_model_spec(**_tiny_spec_kwargs()))
    rng = np.random.default_rng(4)
    batches = [
        {"data": rng.standard_normal((2, *spec.patch_size, 1)).astype(np.float32),
         "seg": rng.integers(0, 3, (2, *spec.patch_size)).astype(np.int32)}
        for _ in range(STEPS)
    ]
    jmodel = JaxNexToU(spec=jspec, dtype=jnp.float32)
    jopt = jt.make_optimizer(jt.poly_lr(**_SCHED))
    template = jt.create_train_state(jmodel, jopt, jnp.asarray(batches[0]["data"][:1]), 5)
    start = randomized(template.model_variables(), 5)
    moment0 = jax.tree_util.tree_map(lambda p: 0.01 * np.asarray(p), start["params"])
    state = pt.create_train_state(NexToU(spec), pt.make_optimizer(pt.poly_lr(**_SCHED)), 0)
    load_train_state(state, start, moment0, 300, spec)
    # the one process's steps, in f64; each of the ranks' steps starts where
    # the one process's did (this network's gradient amplifies f32 rounding
    # about a thousandfold: free-running trajectories part within a step)
    starts, one = [state.state_dict()], []
    for batch in batches:
        one.append(_step_run(starts[-1], batch, dtype=torch.float64))
        starts.append(one[-1]["state"])
    torch.save({"starts": starts[:-1], "batches": batches}, tmp / "starts.pt")
    return {"start": start, "moment0": moment0, "template": template, "jmodel": jmodel,
            "jopt": jopt, "jspec": jspec, "batches": batches, "one": one, "dataset": dataset,
            "run": _Ranks(tmp, dataset)}


def test_two_ranks_step_matches_jax_at_the_global_batch(ranks, monkeypatch):
    """The ranks' first step against ``nextou_tpu``'s ``make_train_step`` on
    both samples from the same state, under ``tests/test_torch_train.py``'s
    "tiny" tolerances. (First in this file: its compilation runs while the
    ranks work.)"""
    import jax.numpy as jnp
    from nextou_tpu import losses as jl
    from nextou_tpu import train as jt
    from tests.test_torch_train import (
        _STEP_TOLERANCES, _assert_trees_close, _port_tree, _two_pass_batch_variance,
    )

    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "0")  # JAX kNN: plain path
    _two_pass_batch_variance(monkeypatch)
    loss_rtol, norm_rtol, params_tol, stats_tol, moment_tol = _STEP_TOLERANCES["tiny"]
    start, template = ranks["start"], ranks["template"]
    opt_state = tuple(
        s._replace(trace=ranks["moment0"]) if "trace" in s._fields
        else s._replace(count=jnp.asarray(300, jnp.int32)) if "count" in s._fields else s
        for s in template.opt_state
    )
    jstate = template.replace(params=start["params"], batch_stats=start["batch_stats"],
                              opt_state=opt_state, step=jnp.asarray(300, jnp.int32))
    jloss = jl.CompoundLossSpec(weight_ti=1e-4, ti=jl.TILossSpec.create(*_TI))
    jstep = jt.make_train_step(ranks["jmodel"], ranks["jopt"], jloss,
                               pl.deep_supervision_weights(len(_tiny_spec().decoder)))
    batch = {k: jnp.asarray(v) for k, v in ranks["batches"][0].items()}
    jstate, want = jstep(jstate, batch)
    got = ranks["run"].result("steps")[0][0]
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=loss_rtol)
    np.testing.assert_allclose(got["grad_norm"], float(want["grad_norm"]), rtol=norm_rtol)
    state = pt.create_train_state(NexToU(_tiny_spec()), pt.make_optimizer(), 0)
    state.load_state_dict(got["state"])
    params, stats, moment = _port_tree(state, template.model_variables(), ranks["jspec"])
    trace = next(s for s in jstate.opt_state if "trace" in s._fields).trace
    _assert_trees_close(params, jstate.params, *params_tol, "parameters")
    _assert_trees_close(stats, jstate.batch_stats, *stats_tol, "BatchNorm statistics")
    _assert_trees_close(moment, trace, *moment_tol, "momentum")


def test_local_share_raises_on_an_uneven_batch(monkeypatch):
    assert local_share(3) == 3 and rank() == 0  # no process group: one rank
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    assert local_share(4) == 2
    with pytest.raises(ValueError, match="not divisible by 2 processes"):
        local_share(3)


def test_synchronized_batch_norm_equals_one_process(ranks):
    inp = _layer_inputs()
    want = _batch_norm_run(inp["x"], inp["g"], inp["weight"], inp["bias"])
    got = [run["bn"] for run in ranks["run"].result("layers")]
    for key in ("y", "dx"):
        torch.testing.assert_close(torch.cat([g[key] for g in got]), want[key],
                                   rtol=0, atol=1e-6, msg=key)
    for key in ("dweight", "dbias"):
        torch.testing.assert_close(got[0][key] + got[1][key], want[key], rtol=0, atol=1e-6,
                                   msg=key)
    for key in ("running_mean", "running_var"):
        assert torch.equal(got[0][key], got[1][key]), key
        torch.testing.assert_close(got[0][key], want[key], rtol=0, atol=1e-6, msg=key)


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_global_loss_equals_one_process(ranks, case):
    inp = _layer_inputs()
    want = _loss_run(case, inp["logits"], inp["target"])
    got = [run[case] for run in ranks["run"].result("layers")]
    assert got[0]["loss"] == got[1]["loss"]  # every rank holds the global loss
    torch.testing.assert_close(got[0]["loss"], want["loss"], rtol=1e-5, atol=0)
    # each rank's gradient is WORLD times its share of the global one
    grad = torch.cat([g["grad"] for g in got]) / WORLD
    assert want["grad"].abs().max() > 0
    torch.testing.assert_close(grad, want["grad"], rtol=1e-5, atol=1e-5 * want["grad"].abs().max())


def test_drop_path_draws_the_global_batch(ranks):
    want = _drop_path_run(_layer_inputs()["drop"])
    runs = ranks["run"].result("layers")
    for i, w in enumerate(want):
        assert torch.equal(torch.cat([run["drop"][i] for run in runs]), w), i
    kept = torch.stack(want).reshape(-1, GLOBAL, 12).ne(0).any(-1)
    assert 0 < kept.sum() < kept.numel()  # rate 0.5 drops some samples, not all


def _relative_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    """``tests/test_sharding.py``'s measure: the L2 distance over the L2 norm,
    floored at 1e-3 for near-zero tensors."""
    a, b = a.double(), b.double()
    return ((a - b).norm() / max(b.norm().item(), 1e-3)).item()


@pytest.mark.parametrize("step", range(STEPS))
def test_two_ranks_of_one_sample_equal_one_process_of_two(ranks, step):
    """Step ``step`` on two ranks of one sample against one process of two
    samples, from the same state. The one process runs in f64: two f32 runs
    of this network part by up to 2.5e-5 in the gradient norm with nothing
    but the thread count changed (one intra-op thread against eight), so an
    f32 reference could not hold rtol 1e-5. Against it the ranks' f32 step
    holds the loss and the gradient norm within rtol 1e-5 (4.0e-7 and
    5.6e-6 in this test); the parameters, BatchNorm statistics and momentum are
    bit-equal across the two ranks, and within the one process's in
    relative L2 per tensor by 1e-5 (parameters and statistics: 3.0e-6 at
    most in this test) and 5e-4 (momentum: 8.7e-5; the gradient of a conv bias
    under a BatchNorm is rounding noise, and one f32 process's lies 2.1e-4
    from the f64 one). ``tests/test_sharding.py`` allows 8e-2."""
    bound = {"model": 1e-5, "momentum": 5e-4}
    got0, got1 = (run[step] for run in ranks["run"].result("steps"))
    want = ranks["one"][step]
    assert got0["loss"] == got1["loss"] and got0["grad_norm"] == got1["grad_norm"]
    np.testing.assert_allclose(got0["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got0["grad_norm"], want["grad_norm"], rtol=1e-5)
    assert got0["state"]["step"] == want["state"]["step"] == 301 + step
    for part in ("model", "momentum"):
        for name, w in want["state"][part].items():
            g = got0["state"][part][name]
            assert torch.equal(g, got1["state"][part][name]), (part, name)
            if w.is_floating_point():
                assert _relative_l2(g, w) < bound[part], (part, name)
            else:
                assert torch.equal(g, w), (part, name)


def test_run_training_on_two_ranks(ranks):
    """``run_training.main`` on two gloo ranks at 2d_tiny: only rank 0
    writes (the log, the plot, plans, checkpoints, splits and the
    validation), the ranks draw different batches, the logged pseudo-Dice
    is that of the ranks' summed statistics and every rank logs the same
    epoch; an odd global batch raises on both."""
    r0, r1 = ranks["run"].result("cli")
    out = r0["output"]
    assert r1["written"] == []
    for name in ("training_log.txt", "plans.json", "dataset.json", "checkpoint_best.pth",
                 "checkpoint_final.pth", "validation/summary.json"):
        assert os.path.join(out, name) in r0["written"], name
    assert "splits_final.json.tmp" in r0["written"]
    with open(os.path.join(ranks["dataset"], out, "training_log.txt")) as f:
        log = f.read()
    assert log.count("data parallel: world size 2, backend gloo, local batch 1") == 1
    assert log.count("epoch 0:") == 1
    assert r0["local_batch"] == r1["local_batch"] == 1
    assert r0["first_batch"]["data"].shape[0] == 1
    assert not np.array_equal(r0["first_batch"]["data"], r1["first_batch"]["data"])
    tp, fp, fn = r0["stats"] + r1["stats"]
    (e0,), (e1,) = r0["log_history"], r1["log_history"]
    np.testing.assert_array_equal(e0["pseudo_dice"], pt.pseudo_dice(tp, fp, fn).double().numpy())
    assert not np.array_equal(r0["stats"], r1["stats"])
    for key in ("train_loss", "first_step_loss", "val_loss", "pseudo_dice", "ema_pseudo_dice"):
        np.testing.assert_array_equal(e0[key], e1[key], err_msg=key)
    assert e0["train_all_reduces"] == e1["train_all_reduces"] > 0
    for r in (r0, r1):
        assert "global batch 3 not divisible by 2 processes" in r["odd"]


def test_predictor_splits_tiles_over_a_list_of_devices(monkeypatch):
    """``build_predictor`` over [cpu, cpu] (``--all-devices``' path), the
    tiny network over 2 x 2 x 2 tiles: one replica per device, the tile
    batch of 3 rounded up to 4 and each forward's 8 tiles (2 mirror variants
    of 4 tiles) split 4 and 4; the probabilities within 1e-6 of one device.
    One device is the one-device path."""
    from nextou_tpu_torch import predict
    from nextou_tpu_torch.parallel import local_devices, replicate_to
    from nextou_tpu_torch.utils import init_weights

    cpu = torch.device("cpu")
    assert local_devices("cpu") == [cpu]
    spec = dataclasses.replace(_tiny_spec(), deep_supervision=False)
    model = init_weights(NexToU(spec), seed=1).eval()
    data = np.random.default_rng(1).standard_normal((10, 20, 20, 1)).astype(np.float32)
    want = predict.build_predictor(model, (0,), tile_batch=3)(data)
    made = []
    monkeypatch.setattr(predict, "replicate_to",
                        lambda m, devices: made.extend(replicate_to(m, devices)) or made)
    pred = predict.build_predictor(model, (0,), tile_batch=3, devices=[cpu, cpu])
    sizes = [[], []]
    for i, m in enumerate(made):
        m.register_forward_hook(lambda mod, args, out, i=i: sizes[i].append(args[0].shape[0]))
    got = pred(data)
    assert made[0] is model and made[1] is not model and len(made) == 2
    assert sizes[0] == sizes[1] and set(sizes[0]) == {4}
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    one = predict.build_predictor(model, (0,), tile_batch=3, devices=[cpu])(data)
    assert np.array_equal(one, want)
