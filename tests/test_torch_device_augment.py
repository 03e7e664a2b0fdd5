"""The port's on-device augmentation (``nextou_tpu_torch/data/device_augment.py``)
against the JAX package's host path, on the CPU.

The port draws each sample's plan on the host in the host path's order and
applies it with torch, so it is held against ``nextou_tpu.data.augment``
(the host path both packages share, bit for bit) rather than against
``nextou_tpu.data.device_augment``, which draws in another order from
``jax.random``, rotates final-size patches with reflect padding and
upsamples the simulated low resolution with a Keys cubic. Here:

- the draws: after ``draw_augment_plan`` the generator is where
  ``augment_sample`` leaves it, over 200 seeds per configuration;
- ``device_augment_batch`` against ``augment_batch`` from one seed, each
  transform forced on alone and all together: data within atol 1e-4 / rtol
  1e-5, seg equal on at least 99.99% of voxels, and exactly where no
  rotation or scaling fires;
- ``affine_resample`` against scipy's ``affine_transform`` and the JAX
  device path's (f32 coordinates there, so the latter loosely), and its
  crop-only evaluation against the crop of the whole volume;
- ``gaussian_blur`` against scipy's ``gaussian_filter`` (atol 5e-5, the JAX
  device path's bound) and the native resampler (bit for bit: the same f32
  adds in the same order);
- the low-resolution operator against the host path's scipy round trip
  (atol 1e-5). It is not held against the JAX device path's
  ``lowres_axis_matrix``: that one upsamples with the Keys cubic
  convolution, a documented deviation from scipy's cubic B-spline, which
  the port does not carry over.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from nextou_tpu.data import augment as jax_augment
from nextou_tpu.data.device_augment import affine_resample as jax_affine_resample
from nextou_tpu_torch import native
from nextou_tpu_torch.data import PatchDataLoader, PatchSampler, PreprocessedDataset, save_case
from nextou_tpu_torch.data.augment import AugmentConfig, _zoom_to, initial_patch_size
from nextou_tpu_torch.data.device_augment import (
    affine_resample,
    device_augment_batch,
    draw_augment_plan,
    gaussian_blur,
    lowres_axis_operator,
)

OFF = dict(p_rotation=0.0, p_scaling=0.0, p_noise=0.0, p_blur=0.0, p_brightness=0.0,
           p_contrast=0.0, p_lowres=0.0, p_gamma_invert=0.0, p_gamma=0.0)
ALL = {k: 1.0 for k in OFF}
# final patch, rotation per axis, dummy 2D: nnU-Net's hooks for each kind
GEOMETRY = {
    "3d": ((8, 14, 12), (np.pi / 6,) * 3, False),
    "dummy_2d": ((6, 16, 14), (np.pi,) * 3, True),
    "2d": ((18, 14), (np.pi,), False),
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread keeps their many small ops from
    waiting on each other's threads where pytest's workers share the cores;
    the results are the same."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(geometry: str, probs: dict, margin: bool = True, mirror: bool = True):
    """The port's and the JAX package's config, and the initial patch."""
    final, rot, dummy = GEOMETRY[geometry]
    kw = dict(probs, rotation_rad=rot, dummy_2d=dummy, final_patch_size=final,
              mirror_axes=tuple(range(len(final))) if mirror else ())
    initial = initial_patch_size(final, rot, dummy) if margin else final
    return AugmentConfig(**kw), jax_augment.AugmentConfig(**kw), initial


def batch(seed: int, initial, channels: int = 2, b: int = 2):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((b, channels, *initial)).astype(np.float32)
    seg = rng.integers(0, 5, (b, *initial)).astype(np.int16)
    return data, seg


@pytest.mark.parametrize("name,geometry,probs", [
    ("default", "3d", {}), ("all", "3d", ALL), ("dummy_2d", "dummy_2d", {}),
    ("2d", "2d", ALL)])
def test_plan_draws_leave_the_generator_where_augment_sample_does(name, geometry, probs):
    cfg, jax_cfg, initial = configs(geometry, probs)
    data, seg = batch(0, initial)
    for seed in range(200):
        host, port = np.random.default_rng(seed), np.random.default_rng(seed)
        jax_augment.augment_sample(data[0].copy(), seg[0].copy(), jax_cfg, host)
        draw_augment_plan(cfg, data[0].shape, port)
        assert port.bit_generator.state == host.bit_generator.state, (name, seed)


ALONE = [(p, "3d", {**OFF, p: 1.0}, False, True) for p in OFF]
TOGETHER = [("mirror", "3d", OFF, True, True), ("all", "3d", ALL, True, True),
            ("all_dummy_2d", "dummy_2d", ALL, True, True), ("all_2d", "2d", ALL, True, True),
            ("default", "3d", {}, True, True), ("all_no_margin", "3d", ALL, True, False)]


@pytest.mark.parametrize("name,geometry,probs,mirror,margin", ALONE + TOGETHER,
                         ids=[case[0] for case in ALONE + TOGETHER])
def test_device_augment_batch_equals_the_host_path(name, geometry, probs, mirror, margin):
    cfg, jax_cfg, initial = configs(geometry, probs, margin, mirror)
    spatial = probs.get("p_rotation", 0.2) > 0 or probs.get("p_scaling", 0.2) > 0
    agree, total = 0, 0
    for seed in range(4):
        data, seg = batch(seed, initial)
        host_rng, port_rng = np.random.default_rng(50 + seed), np.random.default_rng(50 + seed)
        want_d, want_s, _ = jax_augment.augment_batch(data.copy(), seg.copy(), jax_cfg, host_rng)
        plans = [draw_augment_plan(cfg, d.shape, port_rng) for d in data]
        got_d, got_s, _ = device_augment_batch(torch.from_numpy(data), torch.from_numpy(seg),
                                               plans, cfg)
        assert got_d.dtype == torch.float32 and got_s.dtype == torch.int16
        np.testing.assert_allclose(got_d.numpy(), want_d, atol=1e-4, rtol=1e-5)
        if not spatial:
            np.testing.assert_array_equal(got_s.numpy(), want_s)
        agree += int((got_s.numpy() == want_s).sum())
        total += want_s.size
    assert agree >= 0.9999 * total


def test_previous_stage_labels_ride_with_seg():
    """``prev`` (a cascade's previous-stage seg) takes seg's resampling and
    mirrors, as the host path's combined label code does."""
    cfg, jax_cfg, initial = configs("3d", {"p_rotation": 1.0, "p_scaling": 1.0})
    data, seg = batch(2, initial)
    prev = np.random.default_rng(3).integers(0, 3, seg.shape).astype(np.int16)
    want = jax_augment.augment_batch(data.copy(), seg.copy(), jax_cfg, np.random.default_rng(8),
                                     prev.copy())
    rng = np.random.default_rng(8)
    plans = [draw_augment_plan(cfg, d.shape, rng) for d in data]
    got = device_augment_batch(*(torch.from_numpy(a) for a in (data, seg)), plans, cfg,
                               prev=torch.from_numpy(prev))
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=1e-4, rtol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        assert (g.numpy() == w).mean() >= 0.9999


def test_loader_device_mode_gives_the_host_modes_batches(tmp_path):
    """One loader thread each, the same seed: the device mode's raw patches
    and plans, augmented with torch, are the host mode's batches."""
    rng = np.random.default_rng(3)
    for i in range(3):
        seg = np.zeros((12, 40, 36), np.int16)
        seg[3:9, 10:30, 8:28] = rng.integers(1, 3)
        save_case(str(tmp_path), f"case_{i}", rng.standard_normal((1, *seg.shape),
                                                                   dtype=np.float32), seg)
    cfg, _, initial = configs("3d", {"p_rotation": 0.5, "p_lowres": 0.5, "p_blur": 0.5})
    loaders = [PatchDataLoader(PatchSampler(PreprocessedDataset(str(tmp_path)), initial, 2,
                                            seed=5), augment=cfg, seed=9, num_threads=1,
                               device_augment=mode) for mode in (False, True)]
    with loaders[0] as host, loaders[1] as device:
        for _ in range(4):
            want, raw = next(host), next(device)
            assert raw["data"].shape == (2, 1, *initial) and len(raw["plans"]) == 2
            data, seg, _ = device_augment_batch(raw["data"], raw["seg"], raw["plans"], cfg)
            np.testing.assert_allclose(torch.movedim(data, 1, -1).numpy(), want["data"],
                                       atol=1e-4, rtol=1e-5)
            assert (seg.numpy() == want["seg"]).mean() >= 0.9999


def _affine_case(rng, shape):
    dim = len(shape)
    mat = np.eye(dim) + 0.15 * rng.standard_normal((dim, dim))
    center = (np.array(shape) - 1) / 2.0
    return mat, center - mat @ center


@pytest.mark.parametrize("shape", [(19, 23), (13, 17, 11)])
@pytest.mark.parametrize("order,mode", [(0, "constant"), (0, "reflect"), (1, "constant"),
                                        (1, "reflect")])
def test_affine_resample_matches_scipy_and_the_jax_device_path(shape, order, mode):
    rng = np.random.default_rng(len(shape) + 10 * order)
    vol = (rng.integers(0, 6, shape) if order == 0 else rng.standard_normal(shape))
    vol = vol.astype(np.float32)
    mat, off = _affine_case(rng, shape)
    got = affine_resample(torch.from_numpy(vol), mat, off, order, mode, cval=0.0).numpy()
    ref = ndimage.affine_transform(vol, mat, offset=off, order=order, mode=mode)
    jax_got = np.asarray(jax_affine_resample(jnp.asarray(vol), jnp.asarray(mat),
                                             jnp.asarray(off), order, mode))
    # scipy's 'constant' domain, [0, n - 1]; at order 1 the host path's is
    # [-0.5, n - 0.5] with clamped taps, and so is this function's: the half-
    # voxel edge shell between them holds the edge's values, not cval
    inside = np.ones(shape, bool)
    if mode == "constant":
        inside = ndimage.affine_transform(np.ones(shape), mat, offset=off, order=0,
                                          mode="constant") == 1
    if order == 1:
        np.testing.assert_allclose(got[inside], ref[inside], atol=1e-5)
        host = native.affine_transform(vol, mat, off, order, mode)
        np.testing.assert_allclose(got, host, rtol=0, atol=1e-6)
        if mode == "constant":
            shell = ~inside & (host != 0)
            assert shell.sum() > 0 and (got[shell] != 0).all()
    else:
        assert (got == ref).mean() >= 0.999
    # the JAX device path: f32 coordinates (they flip order-0 ties), and the
    # same order-1 constant domain
    if order == 1:
        np.testing.assert_allclose(got, jax_got, atol=2e-4)
    else:
        assert (got == jax_got).mean() >= 0.99
    # the final crop alone is the crop of the whole volume, bit for bit
    origin = tuple(n // 4 for n in shape)
    out = tuple(n // 2 for n in shape)
    crop = affine_resample(torch.from_numpy(vol), mat, off, order, mode, 0.0, out, origin)
    np.testing.assert_array_equal(
        crop.numpy(), got[tuple(slice(o, o + n) for o, n in zip(origin, out))])


@pytest.mark.parametrize("sigma", [0.5, 0.8, 1.0])
@pytest.mark.parametrize("shape", [(14, 18, 10), (9, 21)])
def test_gaussian_blur_matches_scipy_and_the_native_resampler(sigma, shape):
    vol = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    got = gaussian_blur(torch.from_numpy(vol), sigma).numpy()
    np.testing.assert_allclose(got, ndimage.gaussian_filter(vol, sigma), atol=5e-5)
    np.testing.assert_array_equal(got, native.gaussian_filter(vol, sigma))


@pytest.mark.parametrize("n", [64, 224, 192, 324, 398])
def test_lowres_operator_shape_at_the_flagships_extents(n):
    """``round(n * zoom)`` samples and back to ``n``, through ``_zoom_to``'s
    off-by-one guard, at the flagship's final and initial extents."""
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    for zoom in (0.5, 0.5123, 0.63, 0.75, 0.999):
        want = _zoom_to(ndimage.zoom(x, zoom, order=0), (n,), order=3)
        op = lowres_axis_operator(n, zoom)
        assert op.shape == (n, n)
        np.testing.assert_allclose(op @ x, want, atol=1e-5)


@pytest.mark.parametrize("shape,zoom,dummy", [((20, 33, 27), 0.63, False),
                                               ((9, 30, 26), 0.55, True), ((31, 24), 0.8, False)])
def test_lowres_operators_reproduce_the_host_round_trip(shape, zoom, dummy):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    factors = [zoom] * len(shape)
    if dummy:
        factors[0] = 1.0
    want = _zoom_to(ndimage.zoom(x, factors, order=0), shape, order=3)
    y = torch.from_numpy(x).double()
    for ax in range(int(dummy), len(shape)):
        op = torch.from_numpy(lowres_axis_operator(shape[ax], zoom))
        y = torch.movedim(torch.tensordot(op, y, dims=([1], [ax])), 0, ax)
    np.testing.assert_allclose(y.float().numpy(), want, atol=1e-5)


def test_no_transform_is_the_center_crop():
    cfg, _, initial = configs("3d", OFF, mirror=False)
    data, seg = batch(1, initial)
    plans = [draw_augment_plan(cfg, d.shape, np.random.default_rng(0)) for d in data]
    got_d, got_s, _ = device_augment_batch(torch.from_numpy(data), torch.from_numpy(seg),
                                           plans, cfg)
    crop = tuple(slice((i - f) // 2, (i - f) // 2 + f)
                 for i, f in zip(initial, cfg.final_patch_size))
    np.testing.assert_array_equal(got_d.numpy(), data[(slice(None), slice(None), *crop)])
    np.testing.assert_array_equal(got_s.numpy(), seg[(slice(None), *crop)])
