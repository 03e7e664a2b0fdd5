"""The port's planning and preprocessing against ``nextou_tpu``'s, on the CPU:
``plans/planner.py``, ``plans/fingerprint.py``, ``plans/integrity.py``,
``plan_and_preprocess.py``, ``convert_msd.py`` and ``data/synthetic.py``.

The same seeded inputs go through both packages. Tolerance: none. Both are
numpy and scipy on the same arrays, so the JSON files are equal as text,
every array bit for bit, the problem lists string for string.
"""

import dataclasses
import gzip
import json
import os

import numpy as np
import pytest

from nextou_tpu import convert_msd as jax_convert_msd
from nextou_tpu import plan_and_preprocess as jax_pp
from nextou_tpu.data import synthetic as jax_synthetic
from nextou_tpu.plans import fingerprint as jax_fingerprint
from nextou_tpu.plans import integrity as jax_integrity
from nextou_tpu.plans import planner as jax_planner
from nextou_tpu_torch import convert_msd, plan_and_preprocess
from nextou_tpu_torch.data import make_synthetic_dataset
from nextou_tpu_torch.data.io import read_nifti, write_nifti
from nextou_tpu_torch.models.presets import flagship_3d_spec
from nextou_tpu_torch.plans.fingerprint import extract_fingerprint
from nextou_tpu_torch.plans.integrity import verify_dataset_integrity
from nextou_tpu_torch.plans.planner import plan_experiment
from nextou_tpu_torch.train import get_trainer_class

BTCV_SPACING = [0.5999993681907654, 0.296875, 0.296875]
BTCV_MEDIAN_SHAPE_3D = [186.0, 575.5, 480.0]
LABELS_14 = {"background": 0, **{f"organ{i}": i for i in range(1, 14)}}


def _fp(spacings, shapes, crop=1.0):
    return {"spacings": [list(s) for s in spacings],
            "shapes_after_crop": [list(s) for s in shapes],
            "median_relative_size_after_cropping": crop,
            "foreground_intensity_properties_per_channel": {
                "0": {"max": 1200.0, "mean": 80.5, "median": 70.0, "min": -900.0,
                      "percentile_00_5": -850.0, "percentile_99_5": 1100.0, "std": 150.25}}}


def _aniso_mr():
    rng = np.random.default_rng(3)
    n = 20
    spacings = [[float(rng.uniform(0.6, 0.8))] * 2 + [float(rng.uniform(4.0, 6.0))]
                for _ in range(n)]
    shapes = [[512, 512, int(rng.integers(28, 44))] for _ in range(n)]
    return _fp(spacings, shapes, crop=0.7)


# name -> (fingerprint, dataset.json, configurations the plans must hold)
FINGERPRINTS = {
    # the reference plans' BTCV medians (tests/test_planner.py)
    "btcv": (_fp([BTCV_SPACING] * 30, [BTCV_MEDIAN_SHAPE_3D] * 30),
             {"labels": LABELS_14, "channel_names": {"0": "CT"}}, {"3d_fullres_nextou"}),
    # chip_smoke.py's phase 22: five CT cases of 96x320x288 plan the flagship
    "phase22": (_fp([[0.6, 0.297, 0.297]] * 5, [[96, 320, 288]] * 5),
                {"labels": LABELS_14, "channel_names": {"0": "CT"}},
                {"3d_fullres_nextou", "3d_lowres"}),
    # anisotropic MR, the coarsest axis last: transposed, into the 3d_lowres loop
    "aniso_mr": (_aniso_mr(), {"labels": {"background": 0, "a": 1, "b": 2},
                               "channel_names": {"0": "T2"}}, {"3d_lowres"}),
    # spacing ratio exactly two (tests/test_planner.py): the lowres loop ends
    "ratio_two": (_fp([[5.0, 2.5, 2.5]] * 12, [[96, 512, 512]] * 12),
                  {"labels": {"background": 0, "a": 1}, "channel_names": {"0": "CT"}},
                  {"3d_lowres"}),
    # a 2D dataset in nnU-Net's layout: one slice, the slice axis at 999
    "2d": (_fp([[999.0, 1.0, 1.0]] * 6, [[1, 768, 640 + 16 * i] for i in range(6)]),
           {"labels": {"background": 0, "a": 1, "b": 2}, "channel_names": {"0": "MR"}},
           {"2d_nextou"}),
}


@pytest.mark.parametrize("name", list(FINGERPRINTS))
def test_plan_experiment_equals_the_jax_package(name):
    fp, dj, must = FINGERPRINTS[name]
    got = plan_experiment(fp, dj, dataset_name=f"Dataset{name}")
    want = jax_planner.plan_experiment(fp, dj, dataset_name=f"Dataset{name}")
    assert json.dumps(got, indent=2) == json.dumps(want, indent=2)
    assert must <= set(got["configurations"]), sorted(got["configurations"])
    if name == "aniso_mr":
        assert got["transpose_forward"] == [2, 0, 1]


def test_phase22_fingerprint_plans_the_flagship():
    """The planned ``3d_fullres_nextou`` is ``presets.flagship_3d_spec()``,
    field for field, as the port's trainer builds its network from it."""
    fp, dj, _ = FINGERPRINTS["phase22"]
    plans = plan_experiment(fp, dj)
    cfgs = plans["configurations"]
    assert (cfgs["3d_fullres"]["patch_size"], cfgs["3d_fullres"]["batch_size"]) == (
        [64, 192, 160], 2)
    assert cfgs["3d_fullres_nextou"] == {
        "inherits_from": "3d_fullres", "patch_size": [64, 224, 192],
        "UNet_base_num_features": 33, "unet_max_num_features": 324, "UNet_class_name": "NexToU"}
    trainer = get_trainer_class("nnUNetTrainer_NexToU")(
        plans, "3d_fullres_nextou", 0, {**dj, "numTraining": 5}, device="cpu")
    assert dataclasses.asdict(trainer.build_network_spec()) == dataclasses.asdict(
        flagship_3d_spec())


# --- raw datasets ----------------------------------------------------------------------

# (x, y, z) shapes and spacings, the coarsest axis last (so the plans transpose),
# and the zero border that cropping removes
TINY_CASES = [((40, 36, 12), (0.8, 0.8, 3.0), 2), ((44, 40, 14), (0.75, 0.75, 2.5), 3),
              ((38, 42, 10), (0.85, 0.85, 3.5), 1), ((42, 38, 13), (0.8, 0.8, 3.0), 2),
              ((40, 40, 11), (0.7, 0.7, 3.2), 0)]


def write_raw(folder, cases, channels=("CT", "MR"), seed=0, ending=".nii.gz", noise=30,
              block=(4, 4, 2)):
    """A raw dataset in nnU-Net's layout: (x, y, z) volumes, a CT channel in
    int16 HU (+- ``noise``) and an MR channel in f32, labels 0-2 in blocks of
    ``block`` voxels (so that something survives resampling), zero outside
    the border."""
    rng = np.random.default_rng(seed)
    for d in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(folder, d), exist_ok=True)
    for i, (shape, spacing, border) in enumerate(cases):
        inner = tuple(slice(border, n - border) for n in shape)
        inner_shape = tuple(n - 2 * border for n in shape)
        labels = rng.integers(0, 3, tuple(-(-n // c) for n, c in zip(inner_shape, block)))
        for axis, c in enumerate(block):
            labels = labels.repeat(c, axis)
        seg = np.zeros(shape, np.int16)
        seg[inner] = labels[tuple(slice(0, n) for n in inner_shape)]
        images = {
            "CT": lambda: np.where(seg > 0, seg * 120 - 40, -1000)
            + (rng.integers(-noise, noise, shape) if noise else 0),
            "MR": lambda: seg * 2.0 + rng.gamma(2.0, 1.0, shape) + 0.5,
        }
        outside = np.ones(shape, bool)
        outside[inner] = False
        cid = f"case_{i:03d}"
        for c, name in enumerate(channels):
            img = images[name]().astype(np.int16 if name == "CT" else np.float32)
            img[outside] = 0
            write_nifti(os.path.join(folder, "imagesTr", f"{cid}_{c:04d}{ending}"), img,
                        spacing=spacing)
        write_nifti(os.path.join(folder, "labelsTr", f"{cid}{ending}"), seg, spacing=spacing)
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump({"name": "Dataset042_Tiny",
                   "channel_names": {str(c): n for c, n in enumerate(channels)},
                   "labels": {"background": 0, "a": 1, "b": 2}, "numTraining": len(cases),
                   "file_ending": ending}, f)
    return folder


@pytest.fixture(scope="module")
def tiny_raw(tmp_path_factory):
    return write_raw(str(tmp_path_factory.mktemp("raw") / "tiny"), TINY_CASES)


def test_extract_fingerprint_equals_the_jax_package(tiny_raw):
    got = extract_fingerprint(tiny_raw)
    want = jax_fingerprint.extract_fingerprint(tiny_raw)
    assert json.dumps(got) == json.dumps(want)
    # the zero border was cropped, and both channels were sampled
    assert got["shapes_after_crop"][0] == [36, 32, 8]
    assert got["median_relative_size_after_cropping"] < 1.0
    assert set(got["foreground_intensity_properties_per_channel"]) == {"0", "1"}


def _files(folder):
    return sorted(os.path.relpath(os.path.join(d, f), folder)
                  for d, _, fs in os.walk(folder) for f in fs)


def _assert_same_outputs(a, b):
    files = _files(a)
    assert files == _files(b)
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert sorted(za.files) == sorted(zb.files), rel
                for k in za.files:
                    assert za[k].dtype == zb[k].dtype, (rel, k)
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{rel}:{k}")
        else:
            with open(pa) as fa, open(pb) as fb:
                assert fa.read() == fb.read(), rel
    return files


# (x, y, z) 352 x 352 x 80 at (0.8, 0.8, 2.5) mm: the smallest kind of case
# whose plans hold a 3d_lowres (3d_fullres's patch covers under a quarter)
LOWRES_CASES = [((352, 352, 80), (0.8, 0.8, 2.5), 0)]


@pytest.mark.parametrize("run", ["default", "lowres_and_fullres", "fingerprint_only",
                                 "no_preprocess"])
def test_plan_and_preprocess_writes_what_the_jax_package_writes(run, tiny_raw, tmp_path):
    raw, flags = tiny_raw, {
        "default": ["--verify_dataset_integrity"],
        "lowres_and_fullres": ["-c", "3d_lowres", "3d_fullres"],
        "fingerprint_only": ["--fingerprint-only"],
        "no_preprocess": ["--no-preprocess", "--max-cases", "3"],
    }[run]
    if run == "lowres_and_fullres":
        # uncompressed files and no noise: the size, not the entropy, matters here
        raw = write_raw(str(tmp_path / "raw"), LOWRES_CASES, channels=("CT",), ending=".nii",
                        noise=0, block=(88, 88, 20))
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    plan_and_preprocess.main([raw, "-o", port, *flags])
    jax_pp.main([raw, "-o", ref, *flags])
    files = _assert_same_outputs(port, ref)
    want = {"fingerprint_only": ["dataset_fingerprint.json"],
            "no_preprocess": ["dataset.json", "dataset_fingerprint.json", "nnUNetPlans.json"]}
    if run in want:
        assert files == want[run]
        return
    with open(os.path.join(port, "nnUNetPlans.json")) as f:
        plans = json.load(f)
    assert plans["transpose_forward"] == [2, 0, 1]
    idents = {"default": {"nnUNetPlans_2d", "nnUNetPlans_3d_fullres"},
              "lowres_and_fullres": {"nnUNetPlans_3d_lowres", "nnUNetPlans_3d_fullres"}}[run]
    assert {f.split(os.sep)[0] for f in files if os.sep in f} == idents
    n = len(TINY_CASES) if run == "default" else len(LOWRES_CASES)
    assert sum(f.endswith(".npz") for f in files) == n * len(idents)


@pytest.mark.parametrize("fault", ["clean", "missing_channel_and_count",
                                   "undeclared_labels_and_background", "shape_mismatch",
                                   "region_labels", "seg_spacing", "nan", "no_dataset_json",
                                   "no_labels_folder"])
def test_verify_dataset_integrity_equals_the_jax_package(fault, tmp_path):
    """One case per fault of ``tests/test_integrity.py``, and three more."""
    folder = str(tmp_path)
    cases = [((8, 7, 6), (1.0, 1.0, 1.0), 1)] * 2
    write_raw(folder, cases, channels=("MR",))
    dj_path = os.path.join(folder, "dataset.json")
    with open(dj_path) as f:
        dj = json.load(f)
    if fault == "missing_channel_and_count":
        os.remove(os.path.join(folder, "imagesTr", "case_001_0000.nii.gz"))
        dj["numTraining"] = 5
    elif fault == "undeclared_labels_and_background":
        dj["labels"] = {"background": 1, "a": 2}
    elif fault == "shape_mismatch":
        write_nifti(os.path.join(folder, "labelsTr", "case_000.nii.gz"),
                    np.zeros((5, 7, 6), np.int16), spacing=(1, 1, 1))
    elif fault == "region_labels":
        dj["labels"] = {"background": 0, "whole": [1, 2], "core": [2]}
    elif fault == "seg_spacing":
        write_nifti(os.path.join(folder, "labelsTr", "case_000.nii.gz"),
                    np.zeros((8, 7, 6), np.int16), spacing=(1.0, 1.0, 5.0))
    elif fault == "nan":
        img = np.ones((8, 7, 6), np.float32)
        img[2, 3, 1] = np.nan
        write_nifti(os.path.join(folder, "imagesTr", "case_001_0000.nii.gz"), img,
                    spacing=(1, 1, 1))
    elif fault == "no_labels_folder":
        os.rename(os.path.join(folder, "labelsTr"), os.path.join(folder, "labels"))
    with open(dj_path, "w") as f:
        json.dump(dj, f)
    if fault == "no_dataset_json":
        os.remove(dj_path)
    got = verify_dataset_integrity(folder)
    assert got == jax_integrity.verify_dataset_integrity(folder)
    assert (got == []) == (fault in ("clean", "region_labels")), got


@pytest.mark.parametrize("modalities", [("T1", "T2"), ("CT",)])
def test_convert_msd_dataset_writes_what_the_jax_package_writes(modalities, tmp_path):
    msd = tmp_path / "msd"
    for d in ("imagesTr", "labelsTr", "imagesTs"):
        (msd / d).mkdir(parents=True)
    rng = np.random.default_rng(len(modalities))
    shape = (10, 12, 11)
    for i in range(2):
        img = rng.standard_normal(shape + (len(modalities),) * (len(modalities) > 1))
        seg = (rng.random(shape) > 0.8).astype(np.uint8)
        write_nifti(str(msd / "imagesTr" / f"case_{i}.nii.gz"), img.astype(np.float32),
                    spacing=(1.5, 1.5, 2.0, 1.0)[: img.ndim])
        write_nifti(str(msd / "labelsTr" / f"case_{i}.nii.gz"), seg, spacing=(1.5, 1.5, 2.0))
    write_nifti(str(msd / "imagesTs" / "case_9.nii.gz"), img.astype(np.float32),
                spacing=(1.5, 1.5, 2.0, 1.0)[: img.ndim])
    (msd / "dataset.json").write_text(json.dumps({
        "name": "Task99", "modality": {str(c): m for c, m in enumerate(modalities)},
        "labels": {"0": "background", "1": "lesion"}, "numTraining": 2}))
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    got = convert_msd.convert_msd_dataset(str(msd), port, verbose=False)
    want = jax_convert_msd.convert_msd_dataset(str(msd), ref, verbose=False)
    assert got == want
    files = _files(port)
    assert files == _files(ref)
    assert len(files) == 1 + 3 * len(modalities) + 2
    for rel in files:
        with open(os.path.join(port, rel), "rb") as fa, open(os.path.join(ref, rel), "rb") as fb:
            a, b = fa.read(), fb.read()
        if rel.endswith(".gz"):  # the gzip header holds the time of writing
            a, b = gzip.decompress(a), gzip.decompress(b)
        assert a == b, rel
    arr, _ = read_nifti(os.path.join(port, "labelsTr", "case_0.nii.gz"))
    assert arr.dtype == np.int16


@pytest.mark.parametrize("shape,classes", [((48, 40), 3), ((20, 24, 16), 4)])
def test_make_synthetic_dataset_writes_what_the_jax_package_writes(shape, classes, tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    ids = make_synthetic_dataset(port, n_cases=3, shape=shape, num_classes=classes, seed=7)
    assert ids == jax_synthetic.make_synthetic_dataset(ref, n_cases=3, shape=shape,
                                                       num_classes=classes, seed=7)
    assert _assert_same_outputs(port, ref) == [f"{i}.npz" for i in ids]
    with np.load(os.path.join(port, f"{ids[0]}.npz")) as z:
        assert z["data"].shape == (1, *shape) and set(np.unique(z["seg"])) == set(range(classes))
