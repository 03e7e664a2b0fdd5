"""The port's data pipeline (``nextou_tpu_torch.data``: sampler, host
augmentation, loader; ``nextou_tpu_torch.native``) against ``nextou_tpu.data``
on the CPU.

Both packages draw from ``numpy`` generators seeded alike and resample on the
same C++ source (``native/resample.cpp``, of which the port keeps its own
copy), so patches, augmented batches and loader batches must agree bit for
bit. The port's resampler is also held against the scipy calls it replaces,
as ``tests/test_native.py`` holds the JAX package's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy import ndimage

from nextou_tpu import native as jax_native
from nextou_tpu.data import PatchDataLoader as JaxLoader
from nextou_tpu.data import PatchSampler as JaxSampler
from nextou_tpu.data import PreprocessedDataset as JaxDataset
from nextou_tpu.data import augment as jaug
from nextou_tpu.data import make_synthetic_dataset
from nextou_tpu_torch import native
from nextou_tpu_torch.data import PatchDataLoader, PatchSampler, PreprocessedDataset
from nextou_tpu_torch.data import augment as paug

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    out = {}
    for shape in ((12, 40, 36), (48, 44)):
        folder = str(tmp_path_factory.mktemp(f"synth{len(shape)}d"))
        make_synthetic_dataset(folder, n_cases=4, shape=shape, num_classes=4, seed=len(shape))
        out[len(shape)] = folder
    return out


def _assert_same(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dim,patch", [(3, (8, 24, 20)), (2, (32, 24)), (3, (32, 24))])
def test_sampler_draws_the_jax_packages_patches(folders, dim, patch):
    # the last case samples one slice per 2D patch from 3D volumes
    folder = folders[dim]
    jax_s = JaxSampler(JaxDataset(folder), patch, 3, 0.333, seed=5)
    port_s = PatchSampler(PreprocessedDataset(folder), patch, 3, 0.333, seed=5)
    for _ in range(4):
        _assert_same(port_s.sample_batch(), jax_s.sample_batch())
    rng_j, rng_p = np.random.default_rng(9), np.random.default_rng(9)
    _assert_same(port_s.sample_batch(rng_p), jax_s.sample_batch(rng_j))


_EVERYTHING_ON = dict(p_rotation=1.0, p_scaling=1.0, p_noise=1.0, p_blur=1.0, p_brightness=1.0,
                      p_contrast=1.0, p_lowres=1.0, p_gamma_invert=0.5, p_gamma=1.0)


@pytest.mark.parametrize("case", ["default", "all_3d", "dummy_2d", "reflect_3d", "all_2d"])
def test_augment_batch_matches_jax_bit_for_bit(case):
    assert jax_native.available(), "the JAX package's native resampler must be built to compare"
    dim = 2 if case.endswith("2d") and case != "dummy_2d" else 3
    final = (8, 20, 16) if dim == 3 else (20, 16)
    kwargs = {} if case == "default" else dict(_EVERYTHING_ON)
    kwargs.update(mirror_axes=tuple(range(dim)))
    if case == "dummy_2d":
        kwargs.update(dummy_2d=True, rotation_rad=(np.pi,) * 3)
    if case != "reflect_3d":
        kwargs["final_patch_size"] = final
    cfgs = [mod.AugmentConfig(**kwargs) for mod in (jaug, paug)]
    src = final if case == "reflect_3d" else paug.initial_patch_size(
        final, cfgs[1].rotation_rad, cfgs[1].dummy_2d, cfgs[1].scale_range)
    rng = np.random.default_rng(1)
    data = rng.standard_normal((3, 2, *src)).astype(np.float32)
    seg = rng.integers(0, 4, (3, *src)).astype(np.int16)
    for seed in range(3 if case == "default" else 1):
        want = jaug.augment_batch(data.copy(), seg.copy(), cfgs[0], np.random.default_rng(seed))
        got = paug.augment_batch(data.copy(), seg.copy(), cfgs[1], np.random.default_rng(seed))
        assert got[0].shape == (3, 2, *final)
        _assert_same(got, want)


def test_initial_patch_size_and_cascade_noise_match_jax():
    for final, rot, dummy in [((64, 224, 192), (np.pi,) * 3, True),
                              ((128, 128, 128), (np.pi / 6,) * 3, False),
                              ((40, 200), (np.pi / 12,), False), ((512, 512), (np.pi,), False),
                              ((20, 160, 160), (np.pi / 6,) * 3, False)]:
        for scale in ((0.7, 1.4), (0.85, 1.25)):
            got = paug.initial_patch_size(final, rot, dummy, scale)
            assert got == jaug.initial_patch_size(final, rot, dummy, scale), (final, rot, dummy)
    assert paug.initial_patch_size((64, 224, 192), (np.pi,) * 3, True) == (64, 320, 320)
    hot = (np.random.default_rng(2).random((3, 10, 12, 12)) > 0.6).astype(np.float32)
    want = jaug.cascade_onehot_noise(hot.copy(), np.random.default_rng(3), 1.0, 1.0)
    got = paug.cascade_onehot_noise(hot.copy(), np.random.default_rng(3), 1.0, 1.0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim", [3, 2])
def test_loader_with_one_thread_matches_jax(folders, dim):
    final = (8, 20, 16) if dim == 3 else (24, 20)
    cfgs = [mod.AugmentConfig(final_patch_size=final, mirror_axes=tuple(range(dim)),
                              rotation_rad=(np.pi,) * dim if dim == 2 else (np.pi / 6,) * 3)
            for mod in (jaug, paug)]
    src = paug.initial_patch_size(final, cfgs[1].rotation_rad, False, cfgs[1].scale_range)
    loaders = [
        loader_cls(sampler_cls(ds_cls(folders[dim]), src, 2, 0.333, seed=3), augment=cfg,
                   seed=3, num_threads=1, prefetch=2)
        for loader_cls, sampler_cls, ds_cls, cfg in (
            (JaxLoader, JaxSampler, JaxDataset, cfgs[0]),
            (PatchDataLoader, PatchSampler, PreprocessedDataset, cfgs[1]))
    ]
    with loaders[0] as jl, loaders[1] as pl:
        for _ in range(4):
            want, got = next(jl), next(pl)
            assert got["data"].shape == (2, *final, 1) and got["seg"].dtype == np.int32
            for key in ("data", "seg"):
                np.testing.assert_array_equal(got[key], want[key])


def test_loader_surfaces_a_producer_error(folders):
    class Broken(PatchSampler):
        def sample_batch(self, rng=None):
            raise OSError("corrupt case")

    loader = PatchDataLoader(Broken(PreprocessedDataset(folders[2]), (16, 16), 2), num_threads=2)
    with loader, pytest.raises(RuntimeError, match="producer thread failed") as info:
        next(loader)
    assert isinstance(info.value.__cause__, OSError)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(11)


@pytest.mark.parametrize("order", [0, 1, 3])
@pytest.mark.parametrize("shape,out", [((23, 31, 17), (37, 20, 25)), ((40, 40), (25, 61))])
def test_native_zoom_matches_scipy(rng, order, shape, out):
    x = rng.standard_normal(shape).astype(np.float32)
    ref = ndimage.zoom(x, [t / s for t, s in zip(out, x.shape)], order=order)
    np.testing.assert_allclose(native.zoom_to_shape(x, ref.shape, order), ref, atol=1e-5)


@pytest.mark.parametrize("dim", [3, 2])
def test_native_affine_matches_scipy(rng, dim):
    x = rng.standard_normal((23, 31, 17)[:dim]).astype(np.float32)
    mat = np.eye(dim) + 0.1 * rng.standard_normal((dim, dim))
    center = (np.array(x.shape) - 1) / 2.0
    off = center - mat @ center
    ref = ndimage.affine_transform(x, mat, offset=off, order=1, mode="reflect")
    np.testing.assert_allclose(native.affine_transform(x, mat, off, 1, "reflect"), ref, atol=1e-6)
    seg = rng.integers(0, 5, x.shape).astype(np.float32)
    ref0 = ndimage.affine_transform(seg, mat, offset=off, order=0, mode="constant")
    np.testing.assert_array_equal(native.affine_transform(seg, mat, off, 0, "constant"), ref0)


@pytest.mark.parametrize("sigma", [0.5, 1.2])
def test_native_gaussian_matches_scipy(rng, sigma):
    x = rng.standard_normal((14, 18, 10)).astype(np.float32)
    np.testing.assert_allclose(native.gaussian_filter(x, sigma), ndimage.gaussian_filter(x, sigma),
                               atol=1e-5)


def test_native_builds_nothing_on_import_and_raises_on_a_bad_call():
    code = ("import nextou_tpu_torch.native as n, nextou_tpu_torch.data\n"
            "print(n.library.cache_info().currsize)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "0"
    with pytest.raises(RuntimeError):
        native.zoom_to_shape(np.zeros((2, 2, 2, 2, 2), np.float32), (3,) * 5, 1)  # ndim > 4
