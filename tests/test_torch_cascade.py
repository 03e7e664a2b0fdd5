"""The port's 3d_lowres -> 3d_cascade_fullres cascade against the JAX
package's, on the CPU, in f32.

A small labelled dataset on two grids (the cascade stage's and half of it
for the lowres stage) with plans whose configurations are plain U-Nets built
by ``nnUNetTrainer``; the networks' weights are the JAX trainer's initial
state, saved as a ``nextou_tpu`` ``.ckpt``, which both packages serve. Held
equal: ``predict_next_stage``'s segmentations, the cascade loader's batches
(one-hot previous-stage channels with their noise, at the same seed), and
``predict -prev``'s probabilities (the tolerance of
``tests/test_torch_predict.py``), on preprocessed and raw cases; a cascade
configuration without its predictions, or without ``-prev``, fails with the
reference's error. The JAX CLIs compute in f32 here (their trainers'
default is bf16).
"""

import copy
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextou_tpu.predict as jax_predict
import nextou_tpu.predict_next_stage as jax_next_stage
from nextou_tpu.data.synthetic import make_synthetic_case
from nextou_tpu.train import get_trainer_class as jax_trainer_class
from nextou_tpu.train.trainer import NexToUTrainer as JaxNexToUTrainer
from nextou_tpu_torch import predict, predict_next_stage, run_training
from nextou_tpu_torch.data.dataset import save_case
from nextou_tpu_torch.data.io import read_image, write_nifti
from nextou_tpu_torch.train import get_trainer_class
from tests.test_torch_model import assert_close_but_near_ties

NET = {
    "UNet_class_name": "PlainConvUNet", "UNet_base_num_features": 4,
    "unet_max_num_features": 8, "n_conv_per_stage_encoder": [2, 2, 2],
    "n_conv_per_stage_decoder": [1, 1], "pool_op_kernel_sizes": [[1, 1, 1], [2, 2, 2], [2, 2, 2]],
    "conv_kernel_sizes": [[3, 3, 3]] * 3, "batch_dice": True,
    "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
}
PLANS = {
    "dataset_name": "Dataset997_Cascade", "plans_name": "nnUNetPlans",
    "configurations": {
        "3d_fullres": {**NET, "batch_size": 2, "patch_size": [16, 32, 32],
                       "spacing": [1.0, 1.0, 1.0], "data_identifier": "nnUNetPlans_3d_fullres"},
        "3d_lowres": {**NET, "batch_size": 2, "patch_size": [8, 16, 16],
                      "spacing": [2.0, 2.0, 2.0], "data_identifier": "nnUNetPlans_3d_lowres",
                      "next_stage": "3d_cascade_fullres"},
        "3d_cascade_fullres": {"inherits_from": "3d_fullres", "previous_stage": "3d_lowres"},
    },
}
DATASET_JSON = {"labels": {"background": 0, "a": 1, "b": 2}, "numTraining": 5,
                "channel_names": {"0": "img"}, "file_ending": ".nii.gz"}
SHAPE, CASES = (16, 40, 40), [f"case_{i:03d}" for i in range(5)]


@pytest.fixture(autouse=True)
def f32_jax_trainers(monkeypatch):
    """The JAX CLIs build their trainers with the default compute dtype
    (bf16); compare in f32."""
    monkeypatch.setitem(JaxNexToUTrainer.__init__.__kwdefaults__, "compute_dtype", jnp.float32)
    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "0")


def _jax_ckpt(folder, configuration, out):
    """The JAX ``nnUNetTrainer``'s initial state for ``configuration``,
    saved as ``out/checkpoint_final.ckpt`` (with plans.json and dataset.json)."""
    trainer = jax_trainer_class("nnUNetTrainer")(
        PLANS, configuration, 0, DATASET_JSON, preprocessed_folder=folder, output_folder=out,
        compute_dtype=jnp.float32).initialize()
    trainer.save_checkpoint("checkpoint_final.ckpt")
    return os.path.join(out, "checkpoint_final.ckpt")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Five labelled cases on the cascade stage's grid and, subsampled by 2,
    the lowres stage's; a lowres model and a cascade-stage model."""
    root = tmp_path_factory.mktemp("cascade")
    folder = str(root / "pre")
    rng = np.random.default_rng(0)
    for cid in CASES:
        data, seg = make_synthetic_case(rng, SHAPE, 3)
        save_case(os.path.join(folder, "nnUNetPlans_3d_fullres"), cid, data, seg)
        save_case(os.path.join(folder, "nnUNetPlans_3d_lowres"), cid, data[:, ::2, ::2, ::2],
                  seg[::2, ::2, ::2])
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(PLANS, f)
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump(DATASET_JSON, f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JaxNexToUTrainer.__init__.__kwdefaults__, "compute_dtype", jnp.float32)
        _jax_ckpt(folder, "3d_lowres", str(root / "lowres"))
        # the cascade stage's weights do not depend on the predictions: a
        # folder that exists lets the JAX trainer's initialize pass
        _jax_ckpt(folder, "3d_cascade_fullres", str(root / "cascade"))
    return {"folder": folder, "lowres": str(root / "lowres"), "cascade": str(root / "cascade"),
            "root": root}


@pytest.fixture(scope="module")
def next_stage(dataset):
    """The port's ``predict_next_stage`` on the lowres ``.ckpt``."""
    out = predict_next_stage.main([
        dataset["folder"], dataset["lowres"], "-c", "3d_lowres", "--next", "3d_cascade_fullres",
        "-tr", "nnUNetTrainer", "-chk", "checkpoint_final.ckpt", "--device", "cpu"])
    return out


def _segs(folder):
    out = {}
    for cid in CASES:
        with np.load(os.path.join(folder, f"{cid}.npz")) as z:
            out[cid] = z["seg"]
    return out


def test_predict_next_stage_matches_the_jax_cli(dataset, next_stage, tmp_path):
    got = _segs(next_stage)
    folder = str(tmp_path / "pre")
    shutil.copytree(dataset["folder"], folder)
    shutil.rmtree(os.path.join(folder, "predicted_next_stage"))
    jax_next_stage.main([folder, dataset["lowres"], "-c", "3d_lowres", "--next",
                         "3d_cascade_fullres", "-tr", "nnUNetTrainer"])
    want = _segs(os.path.join(folder, "predicted_next_stage", "3d_lowres"))
    for cid in CASES:
        assert got[cid].dtype == np.int16 and got[cid].shape == SHAPE, cid
        np.testing.assert_array_equal(got[cid], want[cid], err_msg=cid)
    assert any(len(np.unique(s)) > 1 for s in got.values())


def test_cascade_loader_batches_match_jax(dataset, next_stage, monkeypatch, tmp_path):
    """The cascade trainers' loaders, one thread, the same seed: the same
    batches bit for bit, the noise on the one-hot channels included; the
    network takes 1 + 2 channels."""
    monkeypatch.setenv("NEXTOU_LOADER_THREADS", "1")
    kw = dict(preprocessed_folder=dataset["folder"], device_da=False, seed=3)
    jax_t = jax_trainer_class("nnUNetTrainer")(
        PLANS, "3d_cascade_fullres", 0, DATASET_JSON, output_folder=str(tmp_path / "j"), **kw)
    port_t = get_trainer_class("nnUNetTrainer")(
        PLANS, "3d_cascade_fullres", 0, DATASET_JSON, output_folder=str(tmp_path / "p"),
        device="cpu", loader_threads=1, **kw)
    assert port_t._num_input_channels() == jax_t._num_input_channels() == 3
    assert port_t.build_network_spec().in_channels == 3
    (jl, jv), (pl, pv) = jax_t.get_dataloaders(), port_t.get_dataloaders()
    assert pl.cascade_noise and not pv.cascade_noise and pl.onehot_labels == (1, 2)
    with jl, pl, jv, pv:
        jit, pit, jvit, pvit = iter(jl), iter(pl), iter(jv), iter(pv)
        for _ in range(4):
            want, got = next(jit), next(pit)
            for key in ("data", "seg"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got["data"].shape == (2, 16, 32, 32, 3)
            hot = got["data"][..., 1:]
            assert set(np.unique(hot)) <= {0.0, 1.0}
        want, got = next(jvit), next(pvit)
        np.testing.assert_array_equal(got["data"], want["data"])


def test_cascade_trains_and_serves_with_prev(dataset, next_stage, tmp_path):
    """run_training on the cascade configuration (1 epoch of 2 iterations,
    the final validation with the -prev channels), then predict -prev: its
    probabilities against the JAX CLI's on the JAX cascade-stage ``.ckpt``,
    preprocessed and raw."""
    folder = dataset["folder"]
    trainer = run_training.main([folder, "3d_cascade_fullres", "0", "-tr", "nnUNetTrainer",
                                 "--epochs", "1", "--iters", "2", "--device", "cpu",
                                 "-o", str(tmp_path / "trained")])
    assert trainer.network.spec.in_channels == 3
    assert np.isfinite(trainer.log_history[0]["train_loss"])
    assert os.path.exists(tmp_path / "trained" / "validation" / "summary.json")

    model = dataset["cascade"]
    common = [model, folder, "3d_cascade_fullres", "-tr", "nnUNetTrainer", "-chk",
              "checkpoint_final.ckpt", "-prev", next_stage, "--save-probabilities",
              "--cases", *CASES[:2]]
    predict.main(common + ["-o", str(tmp_path / "port"), "--device", "cpu"])
    jax_predict.main(common + ["-o", str(tmp_path / "jax")])
    for cid in CASES[:2]:
        with np.load(tmp_path / "port" / f"{cid}.npz") as a, \
                np.load(tmp_path / "jax" / f"{cid}.npz") as b:
            assert a["probabilities"].shape == (*SHAPE, 3)
            assert_close_but_near_ties(a["probabilities"].astype(np.float32),
                                       b["probabilities"].astype(np.float32), err_msg=cid)
            assert np.mean(a["seg"] == b["seg"]) >= 0.999

    # raw: NIfTI cases on a 1.25 mm grid, the predictions resampled onto
    # each case's preprocessed grid (order 0)
    raw = tmp_path / "raw"
    raw.mkdir()
    rng = np.random.default_rng(9)
    for cid in CASES[:2]:
        write_nifti(str(raw / f"{cid}_0000.nii.gz"),
                    rng.normal(0, 1, (32, 32, 13)).astype(np.float32), spacing=(1.25, 1.25, 1.25))
    raw_args = [model, str(raw), "3d_cascade_fullres", "--raw", "-tr", "nnUNetTrainer", "-chk",
                "checkpoint_final.ckpt", "-prev", next_stage, "--cases", *CASES[:2]]
    predict.main(raw_args + ["-o", str(tmp_path / "raw_port"), "--device", "cpu"])
    jax_predict.main(raw_args + ["-o", str(tmp_path / "raw_jax")])
    for cid in CASES[:2]:
        got, _ = read_image(str(tmp_path / "raw_port" / f"{cid}.nii.gz"))
        want, _ = read_image(str(tmp_path / "raw_jax" / f"{cid}.nii.gz"))
        assert got.shape == (32, 32, 13) and np.mean(got == want) >= 0.999, cid


def test_cascade_without_predictions_fails_like_the_reference(dataset, tmp_path):
    folder = str(tmp_path / "pre")
    shutil.copytree(dataset["folder"], folder)
    shutil.rmtree(os.path.join(folder, "predicted_next_stage"), ignore_errors=True)
    kw = dict(preprocessed_folder=folder, output_folder=str(tmp_path / "o"))
    for trainer in (jax_trainer_class("nnUNetTrainer")(PLANS, "3d_cascade_fullres", 0,
                                                         DATASET_JSON, **kw),
                    get_trainer_class("nnUNetTrainer")(PLANS, "3d_cascade_fullres", 0,
                                                       DATASET_JSON, device="cpu", **kw)):
        with pytest.raises(FileNotFoundError, match="needs previous-stage predictions"):
            trainer.get_split()
    args = [dataset["cascade"], folder, "3d_cascade_fullres", "-tr", "nnUNetTrainer",
            "-chk", "checkpoint_final.ckpt", "-o", str(tmp_path / "out")]
    for main in (jax_predict.main, lambda a: predict.main(a + ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="cascade stage: pass -prev"):
            main(copy.copy(args))
    with pytest.raises(SystemExit, match="cascade stage: pass -prev"):
        predict.main(args + ["--raw", "--device", "cpu"])
    assert torch.get_default_dtype() == torch.float32
