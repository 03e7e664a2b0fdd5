"""The port's ``find_best_configuration`` and ``import_torch_checkpoint``
against ``nextou_tpu``'s, on the CPU.

``find_best``: the fixtures of ``tests/test_cli_utils.py`` (the ranking, 2-way
ensembles with ``-ds``, the winner's postprocessing, and none without
cross-validation segs) through both CLIs: the written JSON files are equal,
key for key, but for the commands they name (the port's modules). The
import: an upstream-layout ``.pth`` (``module.`` and ``_orig_mod.`` prefixes,
an ``all_modules`` alias, ``current_epoch``) of a tiny 2D NexToU plan; the
written weights equal the source tensors and the JAX tool's ``.ckpt`` bit
for bit, and ``predict`` serves the folder bit-equal to the same weights
written as a plain checkpoint.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from nextou_tpu import find_best_configuration as jax_find_best
from nextou_tpu import import_torch_checkpoint as jax_import
from nextou_tpu_torch import find_best_configuration, import_torch_checkpoint, predict
from nextou_tpu_torch.compat import variables_to_state_dict
from nextou_tpu_torch.compat.flax_ckpt import read_ckpt
from nextou_tpu_torch.data import make_synthetic_dataset
from nextou_tpu_torch.train import get_trainer_class
from tests.test_train_integration import DATASET_JSON, TINY_PLANS

CONFIG = "2d_tiny"


# --- find_best_configuration -------------------------------------------------------------

def _summary(run, dice):
    (run / "validation").mkdir(parents=True, exist_ok=True)
    (run / "validation" / "summary.json").write_text(
        json.dumps({"foreground_mean": {"Dice": dice}}))


def _ranking(tmp_path):
    for name, dice in (("a", 0.7), ("b", 0.9), ("c", 0.8)):
        _summary(tmp_path / name, dice)
    return [f"{n}={tmp_path / n}" for n in "abc"], []


def _ensembles(tmp_path):
    """Two runs on a 4x4 grid and one on 8x8; the GT under two
    data_identifier folders, the 2d one sorting first with the wrong grid."""
    dsj = {"labels": {"background": 0, "fg": 1}, "numTraining": 1, "channel_names": {"0": "img"}}
    hot = (slice(0, 2), slice(0, 2))
    runs = []
    for name, shape, dice in (("runA", (4, 4), 0.6), ("runB", (4, 4), 0.5),
                              ("runC", (8, 8), 0.4)):
        run = tmp_path / name
        _summary(run, dice)
        probs = np.zeros((*shape, 2), np.float16)
        probs[..., 0] = 1.0
        probs[hot + (0,)] = 0.0
        probs[hot + (1,)] = 1.0
        np.savez(run / "validation" / "case0.npz", probabilities=probs,
                 seg=np.argmax(probs, -1).astype(np.int16))
        (run / "dataset.json").write_text(json.dumps(dsj))
        runs.append(f"{name}={run}")
    ds = tmp_path / "preproc"
    (ds / "nnUNetPlans_2d").mkdir(parents=True)
    (ds / "nnUNetPlans_3d_fullres").mkdir()
    np.savez(ds / "nnUNetPlans_2d" / "case0.npz", seg=np.zeros((1, 2, 2), np.int16))
    gt = np.zeros((4, 4), np.int16)
    gt[0:2, 0:2] = 1
    gt[3, 3] = 1  # a speck that the largest-component rule would remove
    np.savez(ds / "nnUNetPlans_3d_fullres" / "case0.npz", seg=gt[None])
    return runs, ["-ds", str(ds)]


def _postprocessing(tmp_path):
    """Label 1 has a spurious speck (removal helps), label 2 two real
    components (removal hurts)."""
    gt = np.zeros((12, 12), np.int16)
    gt[1:4, 1:4] = 1
    gt[7:10, 1:4] = 2
    gt[7:10, 7:10] = 2
    pred = gt.copy()
    pred[11, 11] = 1
    run = tmp_path / "best_run"
    _summary(run, 0.9)
    np.savez(run / "validation" / "case0.npz", seg=pred)
    _summary(tmp_path / "other_run", 0.85)
    ds = tmp_path / "preproc"
    ds.mkdir()
    np.savez(ds / "case0.npz", seg=gt)
    return [str(run), str(tmp_path / "other_run")], ["-ds", str(ds)]


def _no_cv_segs(tmp_path):
    run = tmp_path / "old_run"
    _summary(run, 0.8)
    np.savez(run / "validation" / "case0.npz", probabilities=np.ones((4, 4, 2), np.float16))
    (run / "dataset.json").write_text(json.dumps(
        {"labels": {"background": 0, "fg": 1}, "numTraining": 1, "channel_names": {"0": "img"}}))
    ds = tmp_path / "preproc"
    ds.mkdir()
    np.savez(ds / "case0.npz", seg=np.zeros((4, 4), np.int16))
    return [str(run)], ["-ds", str(ds)]


FIXTURES = {"ranking": _ranking, "ensembles": _ensembles, "postprocessing": _postprocessing,
            "no_cv_segs": _no_cv_segs}


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_find_best_writes_what_the_jax_package_writes(fixture, tmp_path):
    runs, flags = FIXTURES[fixture](tmp_path)
    written = {}
    for name, module in (("port", find_best_configuration), ("jax", jax_find_best)):
        out = tmp_path / name
        out.mkdir()
        module.main([*runs, *flags, "-o", str(out / "inference_information.json")])
        written[name] = {f: (out / f).read_text() for f in sorted(os.listdir(out))}
    assert list(written["port"]) == list(written["jax"])
    # the commands name the port's modules; everything else is the JAX package's
    want = {f: text.replace("python -m nextou_tpu.", "python -m nextou_tpu_torch.")
            for f, text in written["jax"].items()}
    assert written["port"] == want
    info = json.loads(written["port"]["inference_information.json"])
    assert "python -m nextou_tpu_torch.predict" in info["inference_instructions"]
    assert ("postprocessing.json" in written["port"]) == (fixture != "no_cv_segs"
                                                          and fixture != "ranking")
    if fixture == "ensembles":
        assert info["best_configuration"] == "ensemble runA + runB"
        assert "nextou_tpu_torch.ensemble" in info["inference_instructions"]
    if fixture == "postprocessing":
        assert info["postprocessing"]["remove_all_but_largest_component"] == {
            "1": True, "2": False}


# --- import_torch_checkpoint -------------------------------------------------------------

@pytest.fixture(scope="module")
def upstream(tmp_path_factory):
    """A preprocessed 2d_tiny dataset and an upstream-layout ``.pth`` of a
    NexToU with seeded random weights."""
    root = tmp_path_factory.mktemp("import")
    folder = str(root / "data")
    make_synthetic_dataset(folder, n_cases=2, shape=(64, 64), num_classes=3)
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(TINY_PLANS, f)
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump(DATASET_JSON, f)
    net = get_trainer_class("nnUNetTrainer_NexToU")(
        TINY_PLANS, CONFIG, 0, DATASET_JSON, output_folder=str(root / "scratch"),
        device="cpu").initialize().network
    gen = torch.Generator().manual_seed(0)
    weights = {}
    for name, t in net.state_dict().items():
        if t.is_floating_point() and not name.endswith("relative_pos"):
            t = torch.randn(t.shape, generator=gen) * 0.2
            if name.endswith("running_var"):
                t = t.abs() + 0.5
        weights[name] = t.clone()
    # DDP and torch.compile prefixes, and one of dynamic_network_architectures'
    # aliases beside a conv
    layout = {f"module._orig_mod.{k}": v for k, v in weights.items()}
    conv = next(k for k in weights if k.endswith(".conv.weight"))
    layout["module._orig_mod." + conv.replace(".conv.", ".all_modules.0.")] = weights[conv]
    assert len(layout) == len(weights) + 1
    pth = str(root / "checkpoint_final.pth")
    torch.save({"network_weights": layout, "current_epoch": 7,
                "trainer_name": "nnUNetTrainer_NexToU"}, pth)
    return {"folder": folder, "pth": pth, "weights": weights, "root": root}


def test_import_writes_the_source_weights_and_what_the_jax_tool_writes(upstream, tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    path = import_torch_checkpoint.main([upstream["pth"], upstream["folder"], CONFIG, "-o", port,
                                         "--device", "cpu"])
    jax_import.main([upstream["pth"], upstream["folder"], CONFIG, "-o", ref])
    assert path == os.path.join(port, "checkpoint_final.pth")
    assert sorted(os.listdir(port)) == sorted(
        f.replace(".ckpt", ".pth") for f in os.listdir(ref))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert {k: ckpt[k] for k in ("trainer", "configuration", "imported_from", "epoch")} == {
        "trainer": "nnUNetTrainer_NexToU", "configuration": CONFIG,
        "imported_from": os.path.abspath(upstream["pth"]), "epoch": 7}
    got = ckpt["network_weights"]
    assert set(got) == set(upstream["weights"])
    for name, want in upstream["weights"].items():
        assert torch.equal(got[name], want), name
    # the JAX tool's .ckpt of the same .pth, read without jax
    variables, extra, *_ = read_ckpt(os.path.join(ref, "checkpoint_final.ckpt"))
    assert extra["epoch"] == 7
    spec = predict.load_dataset(upstream["folder"], CONFIG)[2]
    from_jax = variables_to_state_dict(variables, spec)
    assert set(from_jax) == set(got)
    for name, t in from_jax.items():
        assert torch.equal(got[name], t), name


def test_predict_serves_the_imported_folder_as_the_source_weights(upstream, tmp_path):
    model = str(tmp_path / "model")
    import_torch_checkpoint.main([upstream["pth"], upstream["folder"], CONFIG, "-o", model,
                                  "--device", "cpu"])
    plain = tmp_path / "plain"
    plain.mkdir()
    torch.save({"network_weights": upstream["weights"]}, plain / "checkpoint_final.pth")
    out = {}
    for name, folder in (("imported", model), ("plain", str(plain))):
        out[name] = str(tmp_path / f"pred_{name}")
        predict.main([folder, upstream["folder"], CONFIG, "-o", out[name], "--cases", "case_000",
                      "--save-probabilities", "--device", "cpu"])
    with np.load(os.path.join(out["imported"], "case_000.npz")) as a, \
            np.load(os.path.join(out["plain"], "case_000.npz")) as b:
        assert a["probabilities"].shape == (64, 64, 3)
        np.testing.assert_array_equal(a["probabilities"], b["probabilities"])
        np.testing.assert_array_equal(a["seg"], b["seg"])
    # the folder names its plans and dataset, as predict --raw reads them
    assert json.load(open(os.path.join(model, "plans.json"))) == TINY_PLANS
    assert json.load(open(os.path.join(model, "dataset.json"))) == DATASET_JSON


def test_import_refuses_a_pickled_checkpoint_unless_trusted(upstream, tmp_path):
    pickled = str(tmp_path / "pickled.pth")
    layout = {f"module.{k}": v for k, v in upstream["weights"].items()}
    torch.save({"network_weights": layout, "init_args": argparse.Namespace(fold=0)}, pickled)
    args = [pickled, upstream["folder"], CONFIG, "-o", str(tmp_path / "out"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="--trust-checkpoint"):
        import_torch_checkpoint.main(args)
    assert not os.path.exists(tmp_path / "out" / "checkpoint_final.pth")
    import_torch_checkpoint.main(args + ["--trust-checkpoint"])
    got = torch.load(tmp_path / "out" / "checkpoint_final.pth", weights_only=True)
    assert "epoch" not in got
    assert all(torch.equal(got["network_weights"][k], v) for k, v in upstream["weights"].items())


def test_import_loads_strictly(upstream, tmp_path):
    weights = dict(upstream["weights"])
    weights.pop(next(iter(weights)))
    short = str(tmp_path / "short.pth")
    torch.save({"network_weights": weights}, short)
    with pytest.raises(RuntimeError, match="Missing key"):
        import_torch_checkpoint.main([short, upstream["folder"], CONFIG, "-o",
                                      str(tmp_path / "out"), "--device", "cpu"])


def test_import_defaults_to_the_card(upstream, tmp_path):
    """Without ``--device`` the network is built on the card, and the tool
    fails where there is none; it does not carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no card")
    out = tmp_path / "out"
    with pytest.raises((RuntimeError, AssertionError)):  # torch's own: no CUDA device
        import_torch_checkpoint.main([upstream["pth"], upstream["folder"], CONFIG,
                                      "-o", str(out)])
    assert not (out / "checkpoint_final.pth").exists()
