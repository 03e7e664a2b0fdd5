"""The port's trainer (``nextou_tpu_torch.train.trainer``, ``trainers``,
``run_training``) against ``nextou_tpu.train`` on the CPU.

The trainers' hooks (mirroring, rotation, dummy 2D, loss spec) are compared
name by name; a CPU run of the CLI at ``2d_tiny`` (the plans of
``tests/test_train_integration.py``) writes the checkpoints that
``nextou_tpu_torch.predict`` serves; a resume restores epoch, EMA and
momentum; and the first train step of both trainers, from the same state and
on the same loader batch, gives the same loss.
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextou_tpu.data import make_synthetic_dataset
from nextou_tpu.train import TRAINER_REGISTRY as JAX_REGISTRY
from nextou_tpu_torch import predict, run_training
from nextou_tpu_torch.compat import load_train_state
from nextou_tpu_torch.train import TRAINER_REGISTRY, get_trainer_class
from nextou_tpu_torch.train.trainer import PEAK_PER_ESTIMATE, auto_remat
from tests.test_torch_train import _two_pass_batch_variance
from tests.test_train_integration import DATASET_JSON, TINY_PLANS

CONFIG = "2d_tiny"
# a 3D NexToU configuration at a small patch, for the 3D hooks (dummy 2D,
# the TI trainers' 3D lambda and connectivity)
PLANS_3D = {
    "dataset_name": "Dataset998_Synth3d", "plans_name": "nnUNetPlans",
    "configurations": {"3d_tiny": {
        **TINY_PLANS["configurations"][CONFIG], "patch_size": [16, 64, 64],
        "spacing": [3.0, 1.0, 1.0], "pool_op_kernel_sizes": [[1, 1, 1], [1, 2, 2], [2, 2, 2],
                                                             [2, 2, 2], [1, 2, 2]],
        "conv_kernel_sizes": [[1, 3, 3]] + [[3, 3, 3]] * 4,
    }},
}
DATASET_JSON_14 = {"labels": {"background": 0, **{f"o{i}": i for i in range(1, 14)}},
                   "numTraining": 6, "channel_names": {"0": "CT"}}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("synth2d"))
    make_synthetic_dataset(folder, n_cases=6, shape=(64, 64), num_classes=3)
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(TINY_PLANS, f)
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump(DATASET_JSON, f)
    return folder


@pytest.fixture(scope="module")
def trained(dataset):
    """One CPU run of the CLI: 1 epoch of 2 iterations, the reference's 50
    validation iterations, then the final validation."""
    trainer = run_training.main([dataset, CONFIG, "0", "--epochs", "1", "--iters", "2",
                                 "--device", "cpu"])
    return trainer


def _as_dict(spec):
    return None if spec is None else dataclasses.asdict(spec)


@pytest.mark.parametrize("plans,config,dataset_json", [
    (TINY_PLANS, CONFIG, DATASET_JSON), (PLANS_3D, "3d_tiny", DATASET_JSON_14)])
def test_every_registered_name_matches_the_jax_trainers_hooks(plans, config, dataset_json):
    names = sorted(n for n in JAX_REGISTRY if n != "NexToUTrainer")
    assert sorted(n for n in TRAINER_REGISTRY if n != "NexToUTrainer") == names
    for name in names:
        jax_t = JAX_REGISTRY[name](plans, config, 0, dataset_json, compute_dtype=jnp.float32)
        port_t = get_trainer_class(name)(plans, config, 0, dataset_json, device="cpu")
        assert port_t.configure_mirroring() == jax_t.configure_mirroring(), name
        assert port_t.inference_allowed_mirroring_axes == jax_t.inference_allowed_mirroring_axes
        got = port_t.configure_rotation_dummyDA_mirroring_and_initial_patch_size()
        assert got == jax_t.configure_rotation_dummyDA_mirroring_and_initial_patch_size(), name
        assert _as_dict(port_t._loss_spec()) == _as_dict(jax_t._loss_spec()), name
        assert port_t._augment_config() .__dict__ == jax_t._augment_config().__dict__, name
        assert (port_t.num_epochs, port_t.num_iterations_per_epoch,
                port_t.num_val_iterations_per_epoch, port_t.batch_size) == (
            jax_t.num_epochs, jax_t.num_iterations_per_epoch,
            jax_t.num_val_iterations_per_epoch, jax_t.batch_size)
    if config == "3d_tiny":
        bti = get_trainer_class("nnUNetTrainer_NexToU_BTI_Synapse")
        assert bti._loss_spec(bti(plans, config, 0, dataset_json, device="cpu")).weight_ti == 1e-6


def test_what_is_not_ported_raises(dataset, tmp_path, monkeypatch):
    """Nothing of the trainer raises any longer. Data parallel (M10): at a
    world size of 2 the trainer initializes with half the batch per rank and
    broadcasts every parameter and buffer from rank 0
    (``tests/test_torch_parallel.py`` trains on two ranks). What else is
    ported runs: ``nnUNetTrainer`` (the plans' PlainConvUNet) builds;
    on-device augmentation (M9) initializes on the CPU with
    ``device_da=True``, ``"auto"`` resolves to off on the CPU, and a cascade
    with ``device_da=True`` logs the JAX trainer's message and turns it off;
    a cascade fails as the JAX trainer does when its previous stage's
    predictions are missing (tests/test_torch_cascade.py runs one)."""
    kw = dict(preprocessed_folder=dataset, device="cpu", output_folder=str(tmp_path / "out"))
    vanilla = get_trainer_class("nnUNetTrainer")(TINY_PLANS, CONFIG, 0, DATASET_JSON, **kw)
    assert not any(st.gnn for st in vanilla.initialize().model_spec.encoder)
    device_da = get_trainer_class("nnUNetTrainer_NexToU")(
        TINY_PLANS, CONFIG, 0, DATASET_JSON, device_da=True, **kw).initialize()
    assert device_da.device_da is True
    auto = get_trainer_class("nnUNetTrainer_NexToU")(TINY_PLANS, CONFIG, 0, DATASET_JSON, **kw)
    assert auto.device_da == "auto" and auto.initialize().device_da is False
    cascade = json.loads(json.dumps(TINY_PLANS))
    cascade["configurations"]["cascade"] = {"inherits_from": CONFIG, "previous_stage": CONFIG}
    stage = get_trainer_class("nnUNetTrainer_NexToU")(cascade, "cascade", 0, DATASET_JSON,
                                                      device_da=True, **kw).initialize()
    assert stage.device_da is False
    with open(os.path.join(kw["output_folder"], "training_log.txt")) as f:
        assert "device_da disabled: cascade one-hot noise" in f.read()
    with pytest.raises(FileNotFoundError, match="predict_next_stage"):
        stage.get_split()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 0)
    sent = []
    monkeypatch.setattr(torch.distributed, "broadcast", lambda t, src: sent.append((t, src)))
    parallel = get_trainer_class("nnUNetTrainer_NexToU")(TINY_PLANS, CONFIG, 0, DATASET_JSON,
                                                          **kw).initialize()
    assert (parallel.batch_size, parallel.local_batch_size) == (2, 1)
    tensors = [*parallel.network.parameters(), *parallel.network.buffers()]
    assert [t.data_ptr() for t, _ in sent] == [t.data_ptr() for t in tensors]
    assert {src for _, src in sent} == {0}


@pytest.fixture
def one_torch_thread():
    """The 2d_tiny network's ops are small: one intra-op thread keeps them
    from waiting on each other's threads where pytest's workers share the
    cores; the results are the same."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_device_da_trains_on_the_host_paths_batches(dataset, tmp_path, one_torch_thread):
    """``device_da=True`` on the CPU against host DA from the same seed, one
    loader thread each: the first batch, augmented by the train step's own
    path, is the host loader's (data within atol 1e-4 / rtol 1e-5, seg
    equal on 99.99% of voxels), and the first step from the same initial
    state gives the same loss (rtol 1e-4); then 1 epoch of 2 iterations
    (2 validation iterations) trains. Later steps are not compared: this random network's kNN
    selection turns differences in the last bits into different losses."""
    from nextou_tpu_torch.train.train_step import _batch_on

    trainers = {}
    for mode in (False, True):
        trainers[mode] = get_trainer_class("nnUNetTrainer_NexToU")(
            TINY_PLANS, CONFIG, 0, DATASET_JSON, preprocessed_folder=dataset, device="cpu",
            output_folder=str(tmp_path / f"da_{mode}"), device_da=mode, loader_threads=1,
            num_epochs=1, num_iterations_per_epoch=2, seed=11).initialize()
    host_t, device_t = trainers[False], trainers[True]
    (host_loader, _), (device_loader, _) = host_t.get_dataloaders(), device_t.get_dataloaders()
    with host_loader, device_loader:
        want, raw = next(iter(host_loader)), next(iter(device_loader))
    assert raw["data"].shape[2:] == (92, 92) and want["data"].shape[1:] == (64, 64, 1)
    data, seg = _batch_on(device_t.network, raw, device_t._augment_config())
    np.testing.assert_allclose(data.numpy(), want["data"], atol=1e-4, rtol=1e-5)
    assert (seg.numpy() == want["seg"]).mean() >= 0.9999
    _, host_metrics = host_t.train_step(host_t.state, want)
    _, device_metrics = device_t.train_step(device_t.state, raw)
    np.testing.assert_allclose(device_metrics["loss"].item(), host_metrics["loss"].item(),
                               rtol=1e-4)
    device_t.num_val_iterations_per_epoch = 2
    device_t.run_training()
    (entry,) = device_t.log_history
    assert np.isfinite(entry["train_loss"]) and device_t.state.step == 3
    with open(os.path.join(device_t.output_folder, "training_log.txt")) as f:
        assert "device DA: initial patch size (92, 92) -> (64, 64)" in f.read()


def test_cpu_run_training_writes_what_predict_serves(trained, dataset, tmp_path):
    out = trained.output_folder
    for name in ("checkpoint_final.pth", "checkpoint_best.pth", "training_log.txt",
                 "plans.json", "validation/summary.json"):
        assert os.path.exists(os.path.join(out, name)), name
    (entry,) = trained.log_history
    assert np.isfinite(entry["train_loss"]) and np.isfinite(entry["val_loss"])
    assert 0 <= entry["loader_wait_s"] <= entry["train_time_s"] <= entry["epoch_time_s"]
    ckpt = torch.load(os.path.join(out, "checkpoint_final.pth"), weights_only=True)
    assert ckpt["current_epoch"] == 0 and ckpt["optimizer_state"]["step"] == 2
    assert ckpt["trainer_name"] == "nnUNetTrainer_NexToU" and len(ckpt["logging"]) == 1
    with open(os.path.join(out, "validation", "summary.json")) as f:
        summary = json.load(f)
    _, val = trained.get_split()
    assert [c["case"] for c in summary["metric_per_case"]] == val.case_ids
    assert set(summary["mean"]) == {"0", "1", "2"}

    pred = str(tmp_path / "pred")
    predict.main([out, dataset, CONFIG, "-o", pred, "--device", "cpu", "--cases", *val.case_ids])
    for cid in val.case_ids:
        with np.load(os.path.join(pred, f"{cid}.npz")) as z:
            seg = z["seg"]
        with np.load(os.path.join(out, "validation", f"{cid}.npz")) as z:
            np.testing.assert_array_equal(seg, z["seg"])  # the same network, the same TTA


def test_resume_restores_epoch_ema_and_momentum(trained, dataset, tmp_path):
    out = str(tmp_path / "resumed")
    shutil.copytree(trained.output_folder, out)
    shutil.copy(os.path.join(out, "checkpoint_final.pth"),
                os.path.join(out, "checkpoint_latest.pth"))
    # --c with --epochs 1: the restored run is at epoch 1 and trains no more
    resumed = run_training.main([dataset, CONFIG, "0", "--epochs", "1", "--iters", "2",
                                 "--device", "cpu", "-o", out, "--c"])
    assert resumed.current_epoch == 1 and resumed.state.step == 2
    assert resumed.ema_pseudo_dice == trained.ema_pseudo_dice
    assert resumed._best_ema == trained._best_ema
    assert resumed.log_history == trained.log_history
    for a, b in zip(resumed.state.momentum, trained.state.momentum):
        assert torch.equal(a, b)
    assert any(m.abs().sum() > 0 for m in resumed.state.momentum)
    for (name, a), b in zip(resumed.network.state_dict().items(),
                            trained.network.state_dict().values()):
        assert torch.equal(a, b), name

    fresh = get_trainer_class("nnUNetTrainer_NexToU")(
        TINY_PLANS, CONFIG, 0, DATASET_JSON, preprocessed_folder=dataset, device="cpu",
        output_folder=str(tmp_path / "fresh"), seed=7)
    fresh.load_pretrained_weights(os.path.join(out, "checkpoint_final.pth"))
    for (name, a), b in zip(fresh.network.state_dict().items(),
                            trained.network.state_dict().values()):
        assert torch.equal(a, b), name
    assert fresh.state.step == 0 and all(m.abs().sum() == 0 for m in fresh.state.momentum)


def test_auto_remat_rule(monkeypatch):
    """The flagship at batch 2 (an 18.38 GiB estimate) keeps every activation
    on an 80 GB card and recomputes every stage on a 16 GB one; the CPU has
    no budget."""
    estimate = 18.38 * 2**30
    assert auto_remat(estimate, torch.device("cpu"))[0] is False
    for gib, want in ((79.18, False), (16.0, True)):
        props = type("Props", (), {"total_memory": int(gib * 2**30)})()
        monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev, p=props: p)
        remat, reason = auto_remat(estimate, torch.device("cuda"))
        assert remat is want, (gib, reason)
        want_peak = estimate * PEAK_PER_ESTIMATE[want] / 2**30
        assert f"predicted peak {want_peak:.2f} GiB" in reason


@pytest.mark.parametrize("case", ["flagship", "flagship_half_patch", "2d_tiny"])
def test_feature_map_estimate_matches_the_jax_model(case):
    """The port's copy of the planner's feature-map estimate, through
    ``NexToU.compute_conv_feature_map_size`` on the meta device, counts what
    the JAX model's method counts. ``auto_remat`` is calibrated on the
    flagship's count: 18.38 GiB at batch 2."""
    from nextou_tpu.models import NexToU as JaxNexToU
    from nextou_tpu.models import presets as jax_presets
    from nextou_tpu_torch.models import NexToU
    from nextou_tpu_torch.models import presets

    input_size = None
    if case.startswith("flagship"):
        spec, jspec = presets.flagship_3d_spec(), jax_presets.flagship_3d_spec()
        if case == "flagship_half_patch":
            input_size = [s // 2 for s in spec.patch_size]
    else:
        spec = get_trainer_class("nnUNetTrainer_NexToU")(
            TINY_PLANS, CONFIG, 0, DATASET_JSON, device="cpu").build_network_spec()
        jspec = JAX_REGISTRY["nnUNetTrainer_NexToU"](
            TINY_PLANS, CONFIG, 0, DATASET_JSON, compute_dtype=jnp.float32).build_network_spec()
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    got = NexToU(spec, device="meta").compute_conv_feature_map_size(input_size)
    want = JaxNexToU(jspec).compute_conv_feature_map_size(input_size)
    assert got == want > 0
    if case == "flagship":
        assert round(got * 2 * 2 * 6 / 2**30, 2) == 18.38


def test_first_train_step_matches_the_jax_trainer(dataset, tmp_path, monkeypatch):
    """From the JAX trainer's initial state, carried over by
    ``compat.load_train_state``, and on the first batch of each trainer's
    own loader (one thread: bit-equal batches), the port's first step gives
    the JAX trainer's loss within rtol 1e-4 in f32. The reference runs with
    flax BatchNorm's two-pass variance and its plain kNN path."""
    from nextou_tpu.train import get_trainer_class as jax_trainer_class

    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "0")
    monkeypatch.setenv("NEXTOU_LOADER_THREADS", "1")
    _two_pass_batch_variance(monkeypatch)
    common = dict(preprocessed_folder=dataset, remat=False, device_da=False, num_epochs=2,
                  num_iterations_per_epoch=4)
    jax_t = jax_trainer_class("nnUNetTrainer_NexToU")(
        TINY_PLANS, CONFIG, 0, DATASET_JSON, output_folder=str(tmp_path / "jax"),
        compute_dtype=jnp.float32, **common).initialize()
    port_t = get_trainer_class("nnUNetTrainer_NexToU")(
        TINY_PLANS, CONFIG, 0, DATASET_JSON, output_folder=str(tmp_path / "port"),
        device="cpu", loader_threads=1, **common).initialize()
    assert dataclasses.asdict(port_t.model_spec) == dataclasses.asdict(jax_t.model_spec)
    # the JAX trainer's initial state with its He-normal kernels halved, as
    # in tests/test_torch_model.py: at full scale this random network puts a
    # kNN selection on a near tie that f32 rounding resolves differently in
    # the two frameworks (the port's f32 loss equals its f64 loss to 1e-7,
    # the reference's is 3.9e-4 away); halved, both agree to 1e-6
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) * (0.5 if path[-1].key == "kernel" else 1.0),
        jax_t.state.model_variables())
    jstate = jax_t.state.replace(params=variables["params"])
    trace = next(s for s in jstate.opt_state if "trace" in s._fields).trace
    load_train_state(port_t.state, variables, jax.tree_util.tree_map(np.asarray, trace),
                     int(jstate.step), port_t.model_spec)

    (jax_loader, _), (port_loader, _) = jax_t.get_dataloaders(), port_t.get_dataloaders()
    with jax_loader, port_loader:
        jbatch, batch = next(iter(jax_loader)), next(iter(port_loader))
    for key in ("data", "seg"):
        np.testing.assert_array_equal(batch[key], jbatch[key])
    _, want = jax_t.train_step(jstate, {k: jnp.asarray(v) for k, v in jbatch.items()})
    _, got = port_t.train_step(port_t.state, batch)
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), rtol=1e-4)
    # the gradient norm: the reference's f32 rounding moves it by 2e-3 (the
    # port's f32 norm equals its f64 norm to 1e-6)
    np.testing.assert_allclose(got["grad_norm"].item(), float(want["grad_norm"]), rtol=1e-2)


def test_run_training_defaults_to_the_card(dataset, tmp_path):
    """Without ``--device`` the CLI trains on the card and fails where there
    is none (torch's own error); it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no card")
    out = tmp_path / "card"
    with pytest.raises((RuntimeError, AssertionError)):
        run_training.main([dataset, CONFIG, "0", "--epochs", "1", "--iters", "1", "-o", str(out)])
    assert not (out / "checkpoint_final.pth").exists()


def test_validation_only_and_profile_modes(trained, dataset, tmp_path):
    out = str(tmp_path / "val_only")
    shutil.copytree(trained.output_folder, out)
    shutil.rmtree(os.path.join(out, "validation"))
    run_training.main([dataset, CONFIG, "0", "--device", "cpu", "-o", out, "--val", "--npz"])
    (cid, *_) = trained.get_split()[1].case_ids
    with np.load(os.path.join(out, "validation", f"{cid}.npz")) as z:
        assert z["probabilities"].shape == (64, 64, 3) and z["probabilities"].dtype == np.float16
    with open(os.path.join(out, "validation", "summary.json")) as f, \
            open(os.path.join(trained.output_folder, "validation", "summary.json")) as g:
        # the same checkpoint, the same metrics (compared as text: a NaN equals itself)
        assert json.dumps(json.load(f)["mean"]) == json.dumps(json.load(g)["mean"])

    prof = str(tmp_path / "profiled")
    trainer = run_training.main([dataset, CONFIG, "0", "--device", "cpu", "-o", prof,
                                 "--profile", "2"])
    assert trainer.state.step == 3 and not trainer.log_history  # one step outside the trace
    with open(os.path.join(prof, "trace", "trace.json")) as f:
        assert "traceEvents" in json.load(f)
