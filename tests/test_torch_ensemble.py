"""Fold ensembles, saved probabilities, the ensemble CLI, postprocessing and
folder evaluation of the port against the JAX package's, on the CPU.

The pure functions are held against ``nextou_tpu``'s on seeded numpy inputs
(exactly equal: the same numpy and scipy); the CLIs run on the CPU on a
small network's predictions, and where both packages have the CLI, both run
on the same folders and write the same files.
"""

import json
import os

import numpy as np
import pytest
import torch

import nextou_tpu.ensemble as jax_ensemble
import nextou_tpu.evaluate_folder as jax_evaluate_folder
import nextou_tpu.postprocess as jax_postprocess
import nextou_tpu.predict as jax_predict
from nextou_tpu.plans.loader import LabelManager as JaxLabelManager
from nextou_tpu_torch import ensemble, evaluate_folder, postprocess, predict
from nextou_tpu_torch.models import NexToU, presets
from nextou_tpu_torch.plans.loader import LabelManager
from nextou_tpu_torch.utils import init_weights
from tests.test_torch_predict import _write_dataset

REGIONS = {"labels": {"background": 0, "whole": [1, 2], "core": [2]},
           "regions_class_order": [1, 2]}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The networks here are small: one intra-op thread keeps their many
    small ops from waiting on each other's threads where pytest's workers
    share the cores; the results are the same."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("layout", ["siblings", "subfolders", "missing"])
def test_fold_model_folders_match_jax(tmp_path, layout):
    if layout == "subfolders":
        for f in (0, 3):
            os.makedirs(tmp_path / f"fold_{f}")
        base, folds = str(tmp_path), [0, 3]
    else:
        os.makedirs(tmp_path / "tr__cfg__fold_0")
        os.makedirs(tmp_path / "tr__cfg__fold_1")
        base, folds = str(tmp_path / "tr__cfg__fold_0") + "/", [0, 1]
        if layout == "missing":
            folds = [0, 4]
    if layout == "missing":
        for mod in (predict, jax_predict):
            with pytest.raises(SystemExit):
                mod._fold_model_folders(base, folds)
        with pytest.raises(SystemExit):
            predict._fold_model_folders(str(tmp_path), [0])  # neither layout
        return
    got = predict._fold_model_folders(base, folds)
    assert got == jax_predict._fold_model_folders(base, folds)
    assert all(os.path.isdir(p) for p in got) and len(got) == 2


def test_fold_ensemble_predictor_averages_like_jax(monkeypatch):
    rng = np.random.default_rng(0)
    outs = {k: rng.uniform(0, 1, (4, 5, 3)).astype(np.float32) for k in "abc"}
    asked = []

    def fake(model, *args, output="probs", **kwargs):
        asked.append(output)

        def pred(data):
            pred.path = predict.DEVICE_ACCUMULATION
            return outs[model]

        pred.path = None
        return pred

    monkeypatch.setattr(predict, "build_predictor", fake)
    monkeypatch.setattr(jax_predict, "build_predictor", fake)
    data = np.zeros((4, 5, 1), np.float32)
    for models in (["a", "b"], ["a", "b", "c"], ["c"]):
        asked.clear()
        got = predict.build_fold_ensemble_predictor(models, None, output="seg")
        want = jax_predict.build_fold_ensemble_predictor(models, output="seg")
        np.testing.assert_array_equal(got(data), want(data))
        np.testing.assert_allclose(got(data), np.mean([outs[m] for m in models], 0), rtol=1e-6)
        assert got.path == predict.DEVICE_ACCUMULATION
        # an ensemble needs the probabilities; one fold keeps what it asked for
        assert asked == (["seg"] * 2 if len(models) == 1 else ["probs"] * 2 * len(models))


@pytest.mark.parametrize("mode", ["labels", "regions"])
def test_ensemble_case_matches_jax(mode):
    rng = np.random.default_rng(1)
    heads = 2 if mode == "regions" else 4
    probs = [rng.uniform(0, 1, (6, 7, 5, heads)).astype(np.float16) for _ in range(3)]
    lms = (None, None) if mode == "labels" else (LabelManager(REGIONS), JaxLabelManager(REGIONS))
    got = ensemble.ensemble_case(probs, lms[0])
    want = jax_ensemble.ensemble_case(probs, lms[1])
    assert got.dtype == want.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


def _blobby_segs(seed, n=4, shape=(12, 14, 10), labels=4):
    """Label maps with several components per label (a coarse random
    partition, upsampled), and noisy copies of them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        coarse = rng.integers(0, labels, (6, 7, 5))
        gt = coarse.repeat(2, 0).repeat(2, 1).repeat(2, 2).astype(np.int16)
        pred = gt.copy()
        flip = rng.uniform(size=shape) < 0.05
        pred[flip] = rng.integers(0, labels, flip.sum())
        out.append((pred, gt))
    return out


def test_postprocessing_matches_jax():
    cases = _blobby_segs(2)
    for label in range(4):
        got = postprocess.remove_all_but_largest_component(cases[0][0], label)
        want = jax_postprocess.remove_all_but_largest_component(cases[0][0], label)
        np.testing.assert_array_equal(got, want)
    pp = postprocess.determine_postprocessing(cases, [0, 1, 2, 3])
    assert pp == jax_postprocess.determine_postprocessing(cases, [0, 1, 2, 3])
    assert set(pp["remove_all_but_largest_component"]) == {"1", "2", "3"}
    every = {"remove_all_but_largest_component": {"1": True, "2": False, "3": True}}
    for rules in (pp, every):
        for pred, _ in cases:
            np.testing.assert_array_equal(postprocess.apply_postprocessing(pred, rules),
                                          jax_postprocess.apply_postprocessing(pred, rules))


def _load(folder, cid, key="seg"):
    with np.load(os.path.join(folder, f"{cid}.npz")) as z:
        return z[key]


def test_cli_folds_probabilities_ensemble_and_postprocessing(tmp_path, capsys):
    """``predict.main -f 0 1 --save-probabilities`` against the two folds'
    single runs (their mean within float16 rounding, atol 1e-3), the
    ensemble CLI over the single runs (the same seg but at near ties),
    ``-pp`` against ``postprocess apply`` (bit for bit), and the port's
    ``ensemble``, ``postprocess`` and ``evaluate_folder`` CLIs against the JAX
    package's on the same folders (the same files)."""
    spec = presets.small_3d_spec(deep_supervision=False)
    data_dir, model_dir = tmp_path / "data", tmp_path / "model"
    data_dir.mkdir()
    _write_dataset(str(data_dir), spec, spec.patch_size)
    rng = np.random.default_rng(3)
    from nextou_tpu_torch.data.dataset import save_case

    save_case(str(data_dir), "case_001", rng.standard_normal((1, *spec.patch_size)).astype(
        np.float32), np.zeros(spec.patch_size, np.int16))
    for fold in (0, 1):
        os.makedirs(model_dir / f"fold_{fold}")
        model = init_weights(NexToU(spec), seed=10 + fold)
        torch.save({"network_weights": model.state_dict()},
                   model_dir / f"fold_{fold}" / "checkpoint_final.pth")
    base = [str(model_dir), str(data_dir), "3d_small", "-tr", "nnUNetTrainer_NexToU_NoMirroring",
            "--device", "cpu", "--save-probabilities"]
    out = {name: str(tmp_path / name) for name in ("ens", "f0", "f1", "pp", "cli_ens", "jax_ens",
                                                   "applied", "jax_applied")}
    predict.main(base + ["-f", "0", "1", "-o", out["ens"]])
    predict.main(base + ["-f", "0", "-o", out["f0"]])
    predict.main(base + ["-f", "1", "-o", out["f1"]])
    assert capsys.readouterr().out.count(f"({predict.DEVICE_ACCUMULATION})") == 6
    cases = ("case_000", "case_001")
    for cid in cases:
        p0, p1 = (_load(out[f], cid, "probabilities") for f in ("f0", "f1"))
        pe = _load(out["ens"], cid, "probabilities")
        assert pe.dtype == np.float16 and pe.shape == (*spec.patch_size, spec.num_classes)
        np.testing.assert_allclose(pe.astype(np.float32),
                                   (p0.astype(np.float32) + p1.astype(np.float32)) / 2, atol=1e-3)

    ensemble.main([out["f0"], out["f1"], "-o", out["cli_ens"]])
    jax_ensemble.main([out["f0"], out["f1"], "-o", out["jax_ens"]])
    for cid in cases:
        seg = _load(out["cli_ens"], cid)
        np.testing.assert_array_equal(seg, _load(out["jax_ens"], cid))
        # the CLI averages float16 probabilities: a voxel may take another
        # label only where the two best lie within float16 rounding (1e-3)
        top2 = np.sort(_load(out["ens"], cid, "probabilities").astype(np.float32), -1)[..., -2:]
        off = seg != _load(out["ens"], cid)
        assert (top2[off, 1] - top2[off, 0] <= 1e-3).all()
        assert off.mean() < 0.05

    pp_file = str(tmp_path / "postprocessing.json")
    with open(pp_file, "w") as f:
        json.dump({"remove_all_but_largest_component": {"1": True, "2": True}}, f)
    predict.main(base + ["-f", "0", "-o", out["pp"], "-pp", pp_file])
    postprocess.main(["apply", out["f0"], "-o", out["applied"], "-pp", pp_file])
    jax_postprocess.main(["apply", out["f0"], "-o", out["jax_applied"], "-pp", pp_file])
    for cid in cases:
        applied = _load(out["applied"], cid)
        np.testing.assert_array_equal(_load(out["pp"], cid), applied)
        np.testing.assert_array_equal(applied, _load(out["jax_applied"], cid))

    for mod, name in ((postprocess, "port"), (jax_postprocess, "jax")):
        mod.main(["determine", out["f0"], out["f1"], "-o", str(tmp_path / f"pp_{name}.json")])
    for mod, name in ((evaluate_folder, "port"), (jax_evaluate_folder, "jax")):
        mod.main([out["f0"], out["f1"], "-djfile", os.path.join(out["f0"], "dataset.json"),
                  "-o", str(tmp_path / f"summary_{name}.json")])
    for stem in ("pp", "summary"):
        with open(tmp_path / f"{stem}_port.json") as f, open(tmp_path / f"{stem}_jax.json") as g:
            assert json.load(f) == json.load(g)
