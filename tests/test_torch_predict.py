"""The port's sliding-window predictor and prediction CLI, on the CPU.

The predictor is held against ``nextou_tpu.infer.make_device_sliding_predictor``
with the same weights (moved by ``variables_to_state_dict``), the same
volume (made from a numpy seed) and 8-way mirror TTA, in f32.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextou_tpu.data.dataset import save_case
from nextou_tpu.infer import make_device_sliding_predictor as jax_predictor
from nextou_tpu.models import NexToU as JaxNexToU
from nextou_tpu.models import presets as jax_presets
from nextou_tpu_torch.infer import make_device_sliding_predictor
from nextou_tpu_torch.models import NexToU, presets
from nextou_tpu_torch.utils import init_weights
from tests.test_torch_model import (
    assert_close_but_near_ties,
    jax_variables,
    port_from_variables,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_device_predictor_matches_jax(monkeypatch):
    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "0")  # JAX kNN: plain path
    # every mirror variant in one JAX forward: one compile; the same numbers
    # as grouping them (tests/test_inference.py::test_tta_batch_mirrors_matches_sequential)
    monkeypatch.setenv("NEXTOU_TTA_BATCH_MIRRORS", "all")
    jspec = jax_presets.small_3d_spec(deep_supervision=False)
    spec = presets.small_3d_spec(deep_supervision=False)
    # a little larger than the 16x112x96 patch on two axes: 2 x 2 overlapping
    # tiles in two tile batches of 2, each forward two mirror variants on the
    # port's side (all eight in one forward on the JAX side)
    data = np.random.default_rng(11).standard_normal((16, 120, 100, 1)).astype(np.float32)
    jmodel = JaxNexToU(spec=jspec, dtype=jnp.float32)
    variables = jax_variables(jmodel, data[None, :16, :112, :96], seed=2)
    port = port_from_variables(spec, variables)
    axes = (0, 1, 2)

    def jax_apply(x):
        return jmodel.apply(variables, x, train=False)

    want = np.asarray(jax_predictor(
        jax_apply, axes, spec.patch_size, spec.num_classes, tile_batch=2,
        transfer_dtype=jnp.float32,
    )(data))
    got, seg = (
        make_device_sliding_predictor(
            port, axes, spec.patch_size, spec.num_classes, output=output,
            device="cpu", transfer_dtype=torch.float32, tile_batch=2,
        )(data).numpy()
        for output in ("probs", "seg")
    )
    assert got.shape == data.shape[:-1] + (spec.num_classes,)
    assert_close_but_near_ties(got, want, err_msg="probabilities")
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert seg.dtype == np.uint8 and seg.shape == data.shape[:-1]
    np.testing.assert_array_equal(seg, np.argmax(got, axis=-1))
    # the JAX seg output is the argmax of its probabilities (tests/test_inference.py)
    assert np.mean(seg == np.argmax(want, axis=-1)) >= 0.999


def _write_dataset(folder, spec, shape):
    cfg = {
        "batch_size": 2, "patch_size": list(spec.patch_size), "spacing": [1.0, 1.0, 1.0],
        "normalization_schemes": ["ZScoreNormalization"], "use_mask_for_norm": [False],
        "UNet_class_name": "PlainConvUNet",
        "UNet_base_num_features": spec.encoder[0].features,
        "unet_max_num_features": max(st.features for st in spec.encoder),
        "n_conv_per_stage_encoder": [2] * 6, "n_conv_per_stage_decoder": [2] * 5,
        "pool_op_kernel_sizes": [list(st.stride) for st in spec.encoder],
        "conv_kernel_sizes": [list(st.kernel_size) for st in spec.encoder],
        "batch_dice": True,
    }
    plans = {"dataset_name": "D999", "plans_name": "nnUNetPlans",
             "configurations": {"3d_small": cfg}}
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(plans, f)
    labels = {"background": 0, **{f"c{i}": i for i in range(1, spec.num_classes)}}
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump({"labels": labels, "numTraining": 1, "channel_names": {"0": "img"}}, f)
    rng = np.random.default_rng(5)
    save_case(folder, "case_000", rng.standard_normal((1, *shape)).astype(np.float32),
              np.zeros(shape, np.int16))


def test_predict_cli_end_to_end(tmp_path):
    spec = presets.small_3d_spec(deep_supervision=False)
    data_dir, model_dir, out_dir = (tmp_path / d for d in ("data", "model", "out"))
    data_dir.mkdir()
    model_dir.mkdir()
    shape = (16, 120, 100)
    _write_dataset(str(data_dir), spec, shape)
    model = init_weights(NexToU(spec), seed=0)
    torch.save({"network_weights": model.state_dict()}, model_dir / "checkpoint_final.pth")

    proc = subprocess.run(
        [sys.executable, "-m", "nextou_tpu_torch.predict", str(model_dir), str(data_dir),
         "3d_small", "-o", str(out_dir), "-tr", "nnUNetTrainer_NexToU_NoMirroring",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(out_dir / "case_000.npz") as z:
        seg = z["seg"]
    assert seg.shape == shape and seg.dtype == np.uint8
    assert seg.min() >= 0 and seg.max() < spec.num_classes
    with open(out_dir / "dataset.json") as f:
        assert json.load(f)["labels"]["background"] == 0

    from nextou_tpu_torch.predict import build_predictor

    data = np.moveaxis(np.load(data_dir / "case_000.npz")["data"], 0, -1)
    probs = build_predictor(model.eval(), None)(data)
    assert np.mean(np.argmax(probs, -1) == seg) >= 0.999


def test_predict_main_defaults_to_the_card(tmp_path):
    """Without ``--device`` the CLI computes on the card and fails where
    there is none; it does not carry on on the CPU. ``--device cpu`` passes,
    and takes ``--conv-kernel`` (no conv of this small network lies in the
    kernel's region: tests/test_torch_conv.py runs that path)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no card")
    from nextou_tpu_torch import predict

    spec = presets.small_3d_spec(deep_supervision=False)
    data_dir, model_dir, out_dir = (tmp_path / d for d in ("data", "model", "out"))
    data_dir.mkdir()
    model_dir.mkdir()
    _write_dataset(str(data_dir), spec, spec.patch_size)
    torch.save({"network_weights": init_weights(NexToU(spec), seed=0).state_dict()},
               model_dir / "checkpoint_final.pth")
    args = [str(model_dir), str(data_dir), "3d_small", "-o", str(out_dir),
            "-tr", "nnUNetTrainer_NexToU_NoMirroring"]
    with pytest.raises((RuntimeError, AssertionError)):  # torch's own: no CUDA device
        predict.main(args)
    assert not (out_dir / "case_000.npz").exists()
    predict.main(args + ["--device", "cpu", "--conv-kernel", "1"])
    with np.load(out_dir / "case_000.npz") as z:
        assert z["seg"].shape == tuple(spec.patch_size)
    with pytest.raises(SystemExit):
        predict.main(args + ["--device", "cpu", "--conv-kernel", "2"])


def test_load_model_strips_upstream_wrappers(tmp_path):
    """An upstream checkpoint's DDP/compile prefixes and alias keys load."""
    from nextou_tpu_torch.predict import load_model

    spec = presets.small_3d_spec(deep_supervision=False)
    model = init_weights(NexToU(spec), seed=4)
    sd = model.state_dict()
    wrapped = {f"module._orig_mod.{k}": v for k, v in sd.items()}
    wrapped["module.encoder.stages.0.0.convs.0.all_modules.0.weight"] = torch.zeros(1)
    wrapped["decoder.encoder.stages.0.0.convs.0.conv.weight"] = torch.zeros(1)
    torch.save({"network_weights": wrapped}, tmp_path / "checkpoint_final.pth")
    loaded = load_model(spec, str(tmp_path / "checkpoint_final.pth"), torch.device("cpu"))
    got = loaded.state_dict()
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def test_port_imports_neither_jax_nor_flax():
    # every module of the port and the smoke script, in a fresh interpreter:
    # no jax, no flax, no msgpack (the port reads flax checkpoints itself),
    # and nothing of the JAX package (not even a module of it that loads no
    # jax: the port keeps its own copy of what it needs)
    code = (
        "import importlib, pkgutil, sys, nextou_tpu_torch, chip_smoke\n"
        "names = [m.name for m in pkgutil.walk_packages(nextou_tpu_torch.__path__, 'nextou_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "assert len(names) > 30, names\n"
        "new = ['kernels.build', 'kernels.conv', 'tools.exp_conv_v2', 'tools.exp_conv_probe', 'tools.exp_knn_dissect',\n"
        "       'tools.exp_conv_kernel', 'native', 'data.augment', 'data.sampler', 'data.loader',\n"
        "       'infer.evaluate', 'train.checkpoint', 'train.trainer', 'train.trainers', 'run_training',\n"
        "       'data.io', 'data.preprocessing', 'data.resampling', 'paths', 'infer.raw',\n"
        "       'evaluate_folder', 'postprocess', 'ensemble', 'compat.flax_ckpt', 'predict_next_stage',\n"
        "       'models.plain_unet', 'models.residual_unet', 'models.plans_network',\n"
        "       'parallel', 'parallel.distributed', 'parallel.mesh', 'data.synthetic',\n"
        "       'plans.fingerprint', 'plans.integrity', 'plan_and_preprocess', 'convert_msd',\n"
        "       'find_best_configuration', 'import_torch_checkpoint']\n"
        "assert all('nextou_tpu_torch.' + n in names for n in new), names\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'msgpack',\n"
        "                                                          'nextou_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_predictor_budget_and_trainer_names(monkeypatch):
    """A volume whose accumulators fit ``ACC_BUDGET_BYTES`` accumulates on the
    device, one byte over it on the host (it no longer raises), with the same
    result; the trainer names give the mirror axes."""
    from nextou_tpu_torch import predict
    from nextou_tpu_torch.predict import build_predictor, mirror_axes_for

    assert mirror_axes_for("nnUNetTrainer_NexToU_BTI_Synapse", 3) == (0, 1, 2)
    assert mirror_axes_for("nnUNetTrainer_NexToU_TI_NoMirroring", 3) is None
    assert mirror_axes_for("nnUNetTrainer", 3) == (0, 1, 2)
    with pytest.raises(ValueError):
        mirror_axes_for("nnUNetTrainer_Unknown", 3)
    spec = presets.small_3d_spec(deep_supervision=False)
    pred = build_predictor(init_weights(NexToU(spec), seed=1).eval(), None, output="seg")
    data = np.random.default_rng(1).standard_normal((*spec.patch_size, 1)).astype(np.float32)
    acc_bytes = int(np.prod(spec.patch_size)) * (spec.num_classes + 2) * 4
    segs = {}
    for budget, path in ((acc_bytes, predict.DEVICE_ACCUMULATION),
                         (acc_bytes - 1, predict.HOST_ACCUMULATION)):
        monkeypatch.setattr(predict, "ACC_BUDGET_BYTES", budget)
        segs[path] = pred(data)
        assert pred.path == path
    assert segs[predict.HOST_ACCUMULATION].dtype == np.uint8
    np.testing.assert_array_equal(*segs.values())
