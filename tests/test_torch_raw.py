"""The port's raw-volume serving path against the JAX package's, on the CPU.

NIfTI I/O across the two packages, preprocessing and resampling (both run
the same numpy, scipy and C++ resampler, so their outputs are held bit for
bit), ``predict_raw_case`` with the same numpy predictor (bit for bit), the
host-accumulation sliding window (atol 1e-5 in f32: the same adds in the
same order), the predictor's dispatch between device and host accumulation,
a 2d network over a 3d case, and a raw NIfTI folder end to end through
``nextou_tpu_torch.predict.main --raw`` against ``nextou_tpu``'s
``predict_raw_folder`` with the same weights.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextou_tpu.data.io as jax_io
import nextou_tpu.data.preprocessing as jax_pre
import nextou_tpu.data.resampling as jax_rs
from nextou_tpu.infer import make_device_sliding_predictor as jax_device_predictor
from nextou_tpu.infer import sliding_window_predict as jax_sliding_window_predict
from nextou_tpu.infer.raw import predict_raw_case as jax_predict_raw_case
from nextou_tpu.infer.raw import predict_raw_folder as jax_predict_raw_folder
from nextou_tpu.models import NexToU as JaxNexToU
from nextou_tpu.models import presets as jax_presets
from nextou_tpu.plans.loader import PlansManager as JaxPlansManager
from nextou_tpu_torch import predict
from nextou_tpu_torch.data import io, preprocessing as pre, resampling as rs
from nextou_tpu_torch.infer import sliding_window_predict
from nextou_tpu_torch.infer.raw import predict_raw_case
from nextou_tpu_torch.models import NexToU, presets
from nextou_tpu_torch.models.spec import build_model_spec
from nextou_tpu_torch.utils import init_weights
from tests.test_torch_model import jax_variables, port_from_variables

CT_PROPS = {"0": {"mean": 40.0, "std": 120.0, "percentile_00_5": -900.0,
                  "percentile_99_5": 1100.0}}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The networks here are small: one intra-op thread keeps their many
    small ops from waiting on each other's threads where pytest's workers
    share the cores; the results are the same."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- NIfTI, both directions ------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("ending", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
def test_nifti_crosses_packages(tmp_path, dtype, ending, writer):
    rng = np.random.default_rng(0)
    arr = (rng.standard_normal((9, 7, 5)) * 50 + 60).astype(dtype)
    spacing = (0.68, 0.7421875, 3.0)
    path = str(tmp_path / f"img{ending}")
    write, read = (jax_io.write_nifti, io.read_image) if writer == "jax" else (
        io.write_nifti, jax_io.read_image)
    write(path, arr, spacing=spacing)
    got, got_spacing = read(path)
    assert got.dtype == arr.dtype and got.shape == arr.shape  # as stored: (x, y, z)
    np.testing.assert_array_equal(got, arr)
    assert got_spacing == jax_io.read_nifti(path)[1] == io.read_nifti(path)[1]
    assert got_spacing == tuple(float(np.float32(s)) for s in spacing)


# --- preprocessing ---------------------------------------------------------------------

SCHEMES = [
    (["ZScoreNormalization"], [False]),
    (["ZScoreNormalization"], [True]),
    (["CTNormalization"], [False]),
    (["NoNormalization"], [False]),
    (["CTNormalization", "ZScoreNormalization"], [False, True]),
]


def _raw_volume(channels, seed, shape=(10, 24, 22)):
    """HU-like int16 channels, zero outside a box, so that crops crop."""
    rng = np.random.default_rng(seed)
    img = np.zeros((channels, *shape), np.float32)
    img[:, 2:9, 3:20, 4:19] = rng.normal(50, 300, (channels, 7, 17, 15))
    return img.astype(np.int16).astype(np.float32)


@pytest.mark.parametrize("schemes,use_mask", SCHEMES)
def test_preprocessing_matches_jax(schemes, use_mask):
    img = _raw_volume(len(schemes), seed=1)
    seg = (img[0] > 100).astype(np.int16)
    props = {str(c): CT_PROPS["0"] for c in range(len(schemes))}
    for mod in (pre, jax_pre):
        assert mod.shape_for_spacing((10, 24, 22), (3.0, 0.7, 0.7), (2.5, 0.9, 0.9)) == (12, 19, 17)
    want = jax_pre.crop_to_nonzero(img, seg)
    got = pre.crop_to_nonzero(img, seg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(pre.normalize(got[0], schemes, use_mask, props),
                                  jax_pre.normalize(want[0], schemes, use_mask, props))
    for order in (0, 1, 3):
        np.testing.assert_array_equal(pre.resample_to_shape(img[0], (7, 30, 15), order=order),
                                      jax_pre.resample_to_shape(img[0], (7, 30, 15), order=order))
    for kwargs in ({}, {"resampling_data_kwargs": {"order": 3, "order_z": 0, "force_separate_z": None},
                        "resampling_seg_kwargs": {"order": 1, "order_z": 0, "force_separate_z": None}}):
        got = pre.preprocess_case(img, seg, (3.0, 0.7, 0.7), (2.5, 0.9, 0.9), use_mask,
                                  schemes, props, **kwargs)
        want = jax_pre.preprocess_case(img, seg, (3.0, 0.7, 0.7), (2.5, 0.9, 0.9), use_mask,
                                       schemes, props, **kwargs)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


# --- resampling: the cases of tests/test_resampling.py ---------------------------------

RESAMPLING_CASES = {
    # (C, *sp) input shape, integer labels?, new shape, current and new spacing, kwargs
    "separate_z": ((2, 5, 12, 10), False, (5, 8, 7), (3.0, 0.7, 0.7), (3.0, 1.0, 1.0),
                   {"order": 3, "order_z": 0}),
    "separate_z_changes_z": ((1, 6, 8, 8), False, (3, 8, 8), (3.0, 1.0, 1.0), (6.0, 1.0, 1.0),
                             {"order": 3, "order_z": 0}),
    "isotropic": ((1, 6, 5, 8), False, (9, 11, 4), (1.0, 1.0, 1.0), (0.7, 0.5, 2.0),
                  {"order": 3, "order_z": 0}),
    "probabilities_back": ((3, 5, 9, 9), False, (5, 13, 12), (3.0, 1.4, 1.4), (3.0, 0.7, 0.7),
                           {"order": 1, "order_z": 0}),
    "seg_nearest": ((1, 9, 9, 4), True, (14, 13, 4), (1.0, 1.0, 1.0), (0.6, 0.7, 1.0),
                    {"order": 0, "order_z": 0}),
    "seg_onehot": ((1, 9, 9, 4), True, (14, 13, 6), (1.0, 1.0, 1.0), (0.6, 0.7, 0.7),
                   {"order": 1, "order_z": 0}),
    "seg_separate_z_onehot_z": ((1, 4, 6, 6), True, (8, 6, 6), (3.0, 0.5, 0.5),
                                (1.5, 0.5, 0.5), {"order": 1, "order_z": 1,
                                                  "force_separate_z": True}),
    "two_lowres_axes": ((1, 8, 8, 4), False, (6, 6, 6), (3.0, 3.0, 0.5), (4.0, 4.0, 0.33),
                        {"order": 3, "order_z": 0}),
}


@pytest.mark.parametrize("case", sorted(RESAMPLING_CASES))
def test_resampling_matches_jax(case):
    shape, is_seg, new_shape, cur, new, kwargs = RESAMPLING_CASES[case]
    rng = np.random.default_rng(sorted(RESAMPLING_CASES).index(case))
    data = (rng.integers(0, 4, shape).astype(np.int16) if is_seg
            else rng.normal(size=shape).astype(np.float32))
    got = rs.resample_data_or_seg_to_shape(data, new_shape, cur, new, is_seg=is_seg, **kwargs)
    want = jax_rs.resample_data_or_seg_to_shape(data, new_shape, cur, new, is_seg=is_seg, **kwargs)
    assert got.dtype == want.dtype and got.shape == (shape[0], *new_shape)
    np.testing.assert_array_equal(got, want)
    # channels last, moved first: the layout of the probabilities that
    # predict_raw_case resamples back (a view, not contiguous)
    moved = np.moveaxis(np.ascontiguousarray(np.moveaxis(data, 0, -1)), -1, 0)
    np.testing.assert_array_equal(
        rs.resample_data_or_seg_to_shape(moved, new_shape, cur, new, is_seg=is_seg, **kwargs), want)
    if is_seg:
        np.testing.assert_array_equal(rs.resize_segmentation(data[0], new_shape, kwargs["order"]),
                                      jax_rs.resize_segmentation(data[0], new_shape, kwargs["order"]))
    for fn in ("get_do_separate_z", "get_lowres_axis"):
        assert np.array_equal(getattr(rs, fn)(cur), getattr(jax_rs, fn)(cur))


# --- predict_raw_case ------------------------------------------------------------------


def test_predict_raw_case_geometry_round_trip():
    """A crop, an anisotropic resample and a transpose, reverted exactly: an
    all-foreground predictor paints exactly the crop's box at the input's
    geometry (tests/test_inference.py::test_predict_raw_case_geometry_roundtrip)."""
    img = np.zeros((20, 30, 26), np.float32)
    img[4:12, 8:20, 6:18] = 1.0

    def predictor(x):
        fg = np.ones(x.shape[:-1], np.float32)
        return np.stack([1 - fg, fg], axis=-1)

    seg = predict_raw_case(
        predictor, img[None], spacing=(2.0, 1.0, 1.0), target_spacing=(1.0, 1.0, 1.0),
        normalization_schemes=["ZScoreNormalization"], use_mask_for_norm=[False],
        intensity_props=None, transpose_forward=[2, 0, 1], transpose_backward=[1, 2, 0],
    )
    assert seg.shape == img.shape and seg.dtype == np.int16
    np.testing.assert_array_equal(seg == 1, img > 0)


def _numpy_predictor(x):
    """Deterministic probabilities of the input: a softmax of three affine
    maps of its first channel."""
    z = np.stack([x[..., 0], -x[..., 0], 0.5 * x[..., 0] ** 2 - 1.0], axis=-1)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("plans_kwargs", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
def test_predict_raw_case_matches_jax(transpose, plans_kwargs):
    img = _raw_volume(1, seed=3, shape=(12, 26, 22))
    kwargs = dict(
        spacing=(3.0, 0.7, 0.75), target_spacing=(2.5, 0.9, 1.0),
        normalization_schemes=["CTNormalization"], use_mask_for_norm=[False],
        intensity_props=CT_PROPS,
        transpose_forward=[2, 0, 1] if transpose else None,
        transpose_backward=[1, 2, 0] if transpose else None,
    )
    if plans_kwargs:
        kwargs["resampling_data_kwargs"] = {"order": 3, "order_z": 0, "force_separate_z": None}
        kwargs["resampling_probabilities_kwargs"] = {"order": 1, "order_z": 0,
                                                     "force_separate_z": None}
    got = predict_raw_case(_numpy_predictor, img, **kwargs)
    want = jax_predict_raw_case(_numpy_predictor, img, **kwargs)
    assert got.dtype == want.dtype == np.int16 and got.shape == img.shape[1:]
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


# --- a raw NIfTI folder end to end -----------------------------------------------------


def _small_plans(spec, spacing):
    cfg = {
        "batch_size": 2, "patch_size": list(spec.patch_size), "spacing": list(spacing),
        "normalization_schemes": ["CTNormalization"], "use_mask_for_norm": [False],
        "UNet_class_name": "PlainConvUNet",
        "UNet_base_num_features": spec.encoder[0].features,
        "unet_max_num_features": max(st.features for st in spec.encoder),
        "n_conv_per_stage_encoder": [2] * 6, "n_conv_per_stage_decoder": [2] * 5,
        "pool_op_kernel_sizes": [list(st.stride) for st in spec.encoder],
        "conv_kernel_sizes": [list(st.kernel_size) for st in spec.encoder],
        "batch_dice": True,
    }
    return {"dataset_name": "D998", "plans_name": "nnUNetPlans",
            "configurations": {"3d_small": cfg},
            "transpose_forward": [2, 1, 0], "transpose_backward": [2, 1, 0],
            "foreground_intensity_properties_per_channel": CT_PROPS}


def test_raw_folder_end_to_end_matches_jax(tmp_path, monkeypatch):
    """Two raw CT-like NIfTI cases, stored (x, y, z) with 2.5 mm slices:
    transposed, cropped, CT-normalized, resampled to the plans' spacing
    (separate z), predicted (one tile each, no mirroring, bf16 transfer, f32
    compute), resampled back and written. The same weights on both sides;
    the written segs equal on >= 99.9% of voxels (f32 sums in another
    order, tests/test_torch_model.py), shapes and spacings equal."""
    monkeypatch.setenv("NEXTOU_PALLAS_INTERPRET", "0")  # JAX kNN: plain path
    jspec = jax_presets.small_3d_spec(deep_supervision=False)
    spec = presets.small_3d_spec(deep_supervision=False)
    raw, model_dir = tmp_path / "raw", tmp_path / "model"
    raw.mkdir()
    model_dir.mkdir()
    rng = np.random.default_rng(21)
    spacing = (0.8, 0.8, 2.5)
    for cid, (x, y, z) in (("ct_001", (104, 118, 12)), ("ct_002", (96, 110, 13))):
        img = np.zeros((x, y, z), np.int16)
        body = rng.normal(40, 200, (x - 8, y - 6, z)).astype(np.int16)
        body[20:40, 30:60] += 400  # a bright organ-like block
        img[4:-4, 3:-3] = body
        io.write_nifti(str(raw / f"{cid}_0000.nii.gz"), img, spacing=spacing)
    plans = _small_plans(spec, (2.0, 0.9, 0.9))
    dataset_json = {"labels": {"background": 0, "a": 1, "b": 2}, "numTraining": 2,
                    "channel_names": {"0": "CT"}, "file_ending": ".nii.gz"}
    with open(model_dir / "plans.json", "w") as f:
        json.dump(plans, f)
    with open(model_dir / "dataset.json", "w") as f:
        json.dump(dataset_json, f)

    jmodel = JaxNexToU(spec=jspec, dtype=jnp.float32)
    variables = jax_variables(jmodel, np.zeros((1, *spec.patch_size, 1), np.float32), seed=4)
    torch.save({"network_weights": port_from_variables(spec, variables).state_dict()},
               model_dir / "checkpoint_final.pth")
    predict.main([str(model_dir), str(raw), "3d_small", "--raw", "-o", str(tmp_path / "port"),
                  "-tr", "nnUNetTrainer_NexToU_NoMirroring", "--tile-batch", "1",
                  "--device", "cpu"])

    device_pred = jax_device_predictor(
        lambda t: jmodel.apply(variables, t, train=False), None, spec.patch_size,
        spec.num_classes, tile_batch=1)
    jplans = JaxPlansManager(plans)
    jax_predict_raw_folder(lambda x: np.asarray(device_pred(x)), str(raw), str(tmp_path / "jax"),
                           jplans, jplans.get_configuration("3d_small"), dataset_json,
                           verbose=False)
    for cid in ("ct_001", "ct_002"):
        img, sp = io.read_nifti(str(raw / f"{cid}_0000.nii.gz"))
        got, got_sp = io.read_nifti(str(tmp_path / "port" / f"{cid}.nii.gz"))
        want, want_sp = jax_io.read_nifti(str(tmp_path / "jax" / f"{cid}.nii.gz"))
        assert got.shape == want.shape == img.shape and got_sp == want_sp == sp
        assert got.dtype == want.dtype == np.int16
        assert got.max() < spec.num_classes and len(np.unique(got)) > 1
        assert np.mean(got == want) >= 0.999, np.mean(got == want)
        assert (got[:4] == 0).all()  # outside the crop: background


# --- host accumulation -----------------------------------------------------------------


def test_host_accumulation_matches_jax():
    """The same tile function (a softmax of three maps of the input) through
    both packages' host-accumulation sliding windows, f32 throughout: one
    axis shorter than the patch (padded), the others tiled with overlap, the
    last tile batch padded with copies."""
    data = np.random.default_rng(5).standard_normal((10, 41, 37, 1)).astype(np.float32)
    patch = (12, 16, 16)

    def port_tiles(t):
        return torch.softmax(torch.cat([t, -t, 0.5 * t * t], -1).float(), -1)

    def jax_tiles(t):
        return jax.nn.softmax(jnp.concatenate([t, -t, 0.5 * t * t], -1), -1)

    got = sliding_window_predict(port_tiles, data, patch, 3, device="cpu", tile_batch=4,
                                 transfer_dtype=torch.float32)
    want = np.asarray(jax_sliding_window_predict(jax_tiles, data, patch, 3, tile_batch=4))
    assert got.shape == want.shape == (*data.shape[:-1], 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_dispatch_takes_the_host_path_above_the_budget(monkeypatch):
    """Above a patched ``ACC_BUDGET_BYTES`` the predictor accumulates on the
    host, with the same forwards (the tile predictor of the device path: a
    mirror pair per forward, the last tile batch padded): probabilities
    within atol 1e-5 of the device path's, the seg equal, and each call
    records the path it took."""
    spec = presets.small_3d_spec(deep_supervision=False)
    model = init_weights(NexToU(spec), seed=6).eval()
    data = np.random.default_rng(6).standard_normal((16, 120, 100, 1)).astype(np.float32)
    out = {}
    for budget in (predict.ACC_BUDGET_BYTES, 1 << 20):
        monkeypatch.setattr(predict, "ACC_BUDGET_BYTES", budget)
        probs = predict.build_predictor(model, (2,), tile_batch=3)
        seg = predict.build_predictor(model, (2,), tile_batch=3, output="seg")
        out[budget] = probs(data), seg(data), probs.path, seg.path
    (dev_p, dev_s, *dev_paths), (host_p, host_s, *host_paths) = out.values()
    assert dev_paths == [predict.DEVICE_ACCUMULATION] * 2
    assert host_paths == [predict.HOST_ACCUMULATION] * 2
    assert host_p.shape == dev_p.shape == (*data.shape[:-1], spec.num_classes)
    np.testing.assert_allclose(host_p, dev_p, atol=1e-5, rtol=0)
    assert host_s.dtype == dev_s.dtype == np.uint8
    np.testing.assert_array_equal(host_s, np.argmax(host_p, -1))
    assert np.mean(host_s == dev_s) >= 0.999


def test_2d_network_over_a_3d_case_predicts_slice_by_slice():
    spec = build_model_spec(
        in_channels=1, patch_size=(64, 64), n_stages=5, features_per_stage=[8, 16, 16, 16, 16],
        kernel_sizes=[(3, 3)] * 5, strides=[(1, 1)] + [(2, 2)] * 4,
        n_conv_per_stage=[2] * 5, n_conv_per_stage_decoder=[2] * 4, num_classes=3,
        deep_supervision=False,
    )
    model = init_weights(NexToU(spec), seed=7).eval()
    data = np.random.default_rng(7).standard_normal((3, 70, 64, 1)).astype(np.float32)
    for output in ("probs", "seg"):
        pred = predict.build_predictor(model, (0, 1), output=output)
        got = pred(data)
        want = np.stack([pred(data[z]) for z in range(3)])
        assert got.shape == want.shape == (3, 70, 64) + ((3,) if output == "probs" else ())
        np.testing.assert_array_equal(got, want)
        assert pred.path == predict.DEVICE_ACCUMULATION


def test_cli_refuses_saved_probabilities_with_raw_and_empty_postprocessing(tmp_path):
    """As the reference's CLI: ``--raw`` writes NIfTI segs at the input's
    geometry, so it takes no ``--save-probabilities``; a ``-pp`` file must
    carry the operations (or an ``inference_information.json`` that holds
    them)."""
    with pytest.raises(SystemExit):
        predict.main([str(tmp_path), str(tmp_path), "3d_small", "--raw", "-o", str(tmp_path / "o"),
                      "--save-probabilities", "--device", "cpu"])
    rules = {"remove_all_but_largest_component": {"1": True}}
    for name, content in (("empty.json", {}), ("info.json", {"postprocessing": rules})):
        with open(tmp_path / name, "w") as f:
            json.dump(content, f)
    with pytest.raises(SystemExit):
        predict.load_postprocessing(str(tmp_path / "empty.json"))
    assert predict.load_postprocessing(str(tmp_path / "info.json")) == rules
