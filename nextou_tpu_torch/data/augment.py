"""Host-side data augmentation (NumPy/SciPy and the native resampler).

Counterpart of ``nextou_tpu/data/augment.py``, carried over as it is: the
same draws from the same ``numpy`` generator in the same order, so that a
seed gives the JAX package's patches bit for bit. It reproduces the nnU-Net
v2 default training pipeline the reference inherits: spatial rotation and
scaling, Gaussian noise and blur, multiplicative brightness, contrast,
simulated low resolution, gamma (plain and inverted), and mirroring, with
nnU-Net's trigger probabilities. The NoMirroring trainers pass
``mirror_axes=()``.

Rotation follows nnU-Net's sample-larger-then-crop: set
``AugmentConfig.final_patch_size`` and feed patches of
:func:`initial_patch_size`; the spatial transform resamples the larger
source patch and center-crops to the final size, so border voxels read real
image data. Without ``final_patch_size`` the approximation (rotate the final
patch with edge reflection) remains, for callers that cannot supply a margin.

The affine resampling and the Gaussian blur run on the port's native
resampler (``nextou_tpu_torch/native``), whose contract is the scipy call
it replaces; the low-resolution zoom is scipy's. Everything runs on the
host, overlapped with the card's work by the prefetching loader.

The device path is ``data/device_augment.py``: ``draw_augment_plan`` makes
exactly this module's draws, in this order, without touching a voxel, and
``device_augment_batch`` applies them on the card to the same initial-size
patches, giving this module's batch within float rounding (the trainer's
``device_da``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy import ndimage

from nextou_tpu_torch import native


def _affine(x, mat, offset, order, mode, cval=0.0):
    """``scipy.ndimage.affine_transform`` (orders 0/1, reflect/constant) on
    the native resampler."""
    return native.affine_transform(np.asarray(x, np.float32), mat, offset, order, mode, cval)


def _gauss(x, sigma):
    return native.gaussian_filter(np.asarray(x, np.float32), sigma)


@dataclass
class AugmentConfig:
    rotation_rad: tuple[float, ...] = (0.5235987755982988,) * 3  # ±30°
    # anisotropic 3D patches: rotate in-plane only (nnU-Net's dummy-2D DA)
    dummy_2d: bool = False
    p_rotation: float = 0.2
    scale_range: tuple[float, float] = (0.7, 1.4)
    p_scaling: float = 0.2
    p_noise: float = 0.1
    noise_variance: tuple[float, float] = (0.0, 0.1)
    p_blur: float = 0.2
    blur_sigma: tuple[float, float] = (0.5, 1.0)
    p_brightness: float = 0.15
    brightness_range: tuple[float, float] = (0.75, 1.25)
    p_contrast: float = 0.15
    contrast_range: tuple[float, float] = (0.75, 1.25)
    p_lowres: float = 0.25
    lowres_zoom: tuple[float, float] = (0.5, 1.0)
    p_gamma_invert: float = 0.1
    p_gamma: float = 0.3
    gamma_range: tuple[float, float] = (0.7, 1.5)
    mirror_axes: tuple[int, ...] = field(default_factory=tuple)
    # Exact nnU-Net rotation semantics: when set, spatial DA expects input
    # patches of :func:`initial_patch_size` and center-crops every output to
    # this final size (sample-larger-then-crop). None = legacy reflect-pad
    # approximation on final-size patches.
    final_patch_size: tuple[int, ...] | None = None


def initial_patch_size(
    final_patch_size,
    rotation_rad,
    dummy_2d: bool,
    scale_range: tuple[float, float] = (0.7, 1.4),
):
    """The larger patch to EXTRACT so that rotation+scaling+crop never reads
    outside it — the substrate's initial-patch-size computation ([substrate]
    batchgenerators ``get_patch_size``, hooked by the trainer DA config at
    ``nnUNetTrainer_NexToU_NoMirroring.py:5-10``): take the final extent
    vector, rotate it by each max Euler angle (capped at 90°) one axis at a
    time, keep the componentwise max, divide by ``min(scale_range)``. For
    dummy-2D DA only the in-plane axes grow (the depth axis is never
    rotated or scaled cross-plane)."""
    final = np.asarray(final_patch_size, np.float64)
    dim = len(final)
    rots = list(rotation_rad) + [rotation_rad[-1]] * (dim - len(rotation_rad))
    rots = [min(np.pi / 2.0, abs(r)) for r in rots]

    if dummy_2d and dim == 3:
        inner = initial_patch_size(final[1:], rots[:1], False, scale_range)
        return (int(final_patch_size[0]), *inner)

    extent = final.copy()
    if dim == 3:
        axis_pairs = ((1, 2), (0, 2), (0, 1))
        for (i, j), ang in zip(axis_pairs, rots[:3]):
            r = np.eye(3)
            c, s = np.cos(ang), np.sin(ang)
            r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
            extent = np.maximum(extent, np.abs(r @ final))
    else:
        c, s = np.cos(rots[0]), np.sin(rots[0])
        r = np.array([[c, -s], [s, c]])
        extent = np.maximum(extent, np.abs(r @ final))
    extent = extent / min(scale_range)
    out = []
    for e, f in zip(extent, final):
        n = int(np.round(e))
        # force an EVEN margin per axis: then resampling the larger patch
        # about its own center and center-cropping lands on EXACTLY the
        # final-size grid centered on the source center ((src-1)/2 - k =
        # (final-1)/2 for k = (src-final)/2), i.e. the substrate's
        # direct-to-final-grid semantics with no half-voxel shift
        if (n - int(f)) % 2:
            n += 1
        out.append(max(n, int(f)))
    return tuple(out)


def _center_crop(x: np.ndarray, final, lead: int = 0):
    """Center-crop the trailing spatial dims of ``x`` to ``final``."""
    sp = x.shape[lead:]
    lo = [(s - f) // 2 for s, f in zip(sp, final)]
    sl = (slice(None),) * lead + tuple(
        slice(l, l + f) for l, f in zip(lo, final)
    )
    return x[sl]


def _spatial(data, seg, cfg: AugmentConfig, rng: np.random.Generator):
    dim = seg.ndim
    final = cfg.final_patch_size
    if final is not None and tuple(seg.shape) == tuple(final):
        # no margin supplied (e.g. validation-shaped input): fall back to
        # the reflect approximation rather than crop into the patch
        final = None
    do_rot = rng.uniform() < cfg.p_rotation
    do_scale = rng.uniform() < cfg.p_scaling
    if not (do_rot or do_scale):
        if final is not None:
            return _center_crop(data, final, 1), _center_crop(seg, final)
        return data, seg

    # build affine: rotation (per-axis Euler) composed with isotropic scale
    mat = np.eye(dim)
    if do_rot:
        if dim == 3 and cfg.dummy_2d:
            # rotate only within the in-plane axes (1, 2)
            ang = rng.uniform(-cfg.rotation_rad[0], cfg.rotation_rad[0])
            c, s = np.cos(ang), np.sin(ang)
            r = np.eye(3)
            r[1, 1], r[1, 2], r[2, 1], r[2, 2] = c, -s, s, c
            mat = mat @ r
        elif dim == 3:
            angles = [rng.uniform(-a, a) for a in cfg.rotation_rad[:3]]
            for axis_pair, ang in zip(((1, 2), (0, 2), (0, 1)), angles):
                r = np.eye(3)
                i, j = axis_pair
                c, s = np.cos(ang), np.sin(ang)
                r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
                mat = mat @ r
        else:
            ang = rng.uniform(-cfg.rotation_rad[0], cfg.rotation_rad[0])
            c, s = np.cos(ang), np.sin(ang)
            mat = mat @ np.array([[c, -s], [s, c]])
    if do_scale:
        scale = rng.uniform(*cfg.scale_range)
        if dim == 3 and cfg.dummy_2d:
            mat = mat @ np.diag([1.0, scale, scale])
        else:
            mat = mat * scale

    center = (np.array(seg.shape) - 1) / 2.0
    offset = center - mat @ center
    out_d = np.empty_like(data)
    for c in range(data.shape[0]):
        out_d[c] = _affine(data[c], mat, offset, 1, "reflect")
    out_s = _affine(
        seg.astype(np.float32), mat, offset, 0, "constant"
    ).astype(seg.dtype)
    if final is not None:
        # sample-larger-then-crop: the even margin (initial_patch_size)
        # makes this center crop EXACTLY the final-size resample grid
        # centered on the source patch center — border voxels read real
        # image data, never the reflect padding
        return _center_crop(out_d, final, 1), _center_crop(out_s, final)
    return out_d, out_s


def _gamma_channel(x, gamma_range, inverted, rng: np.random.Generator):
    """batchgenerators ``augment_gamma`` semantics on one channel: two-sided
    gamma draw (50% in [lo, 1) when lo < 1, else [max(lo,1), hi]) and
    ``retain_stats=True`` (nnU-Net passes it) — mean/std restored after the
    power transform. The ``invert_image`` branch (negate, gamma, negate)
    algebraically equals the 1-(1-t)^g form with stats retained on the
    original sign."""
    mean_stat, sd_stat = x.mean(), x.std()
    if rng.uniform() < 0.5 and gamma_range[0] < 1:
        gamma = rng.uniform(gamma_range[0], 1.0)
    else:
        gamma = rng.uniform(max(gamma_range[0], 1.0), gamma_range[1])
    mn, rngv = x.min(), np.ptp(x)
    t = (x - mn) / (rngv + 1e-7)
    t = 1.0 - (1.0 - t) ** gamma if inverted else t**gamma
    x = t * rngv + mn
    return (x - x.mean()) / (x.std() + 1e-8) * sd_stat + mean_stat


def _intensity(data, cfg: AugmentConfig, rng: np.random.Generator):
    """Per-channel factor/statistics semantics follow the batchgenerators
    transforms nnU-Net v2 configures (per_channel=True for blur sigma,
    brightness, contrast, lowres zoom, gamma; noise is joint)."""
    C = data.shape[0]
    if rng.uniform() < cfg.p_noise:
        # batchgenerators' augment_gaussian_noise passes the value drawn
        # from noise_variance directly as np.random.normal's *scale* (std),
        # despite the name — no sqrt, or the noise is ~3x too strong
        sd = rng.uniform(*cfg.noise_variance)
        data = data + rng.normal(0, sd, data.shape).astype(np.float32)
    if rng.uniform() < cfg.p_blur:
        for c in range(C):
            if rng.uniform() < 0.5:
                sigma = rng.uniform(*cfg.blur_sigma)
                data[c] = _gauss(data[c], sigma)
    if rng.uniform() < cfg.p_brightness:
        for c in range(C):
            data[c] = data[c] * rng.uniform(*cfg.brightness_range)
    if rng.uniform() < cfg.p_contrast:
        for c in range(C):
            factor = rng.uniform(*cfg.contrast_range)
            mean = data[c].mean()
            mn, mx = data[c].min(), data[c].max()
            data[c] = np.clip((data[c] - mean) * factor + mean, mn, mx)
    if rng.uniform() < cfg.p_lowres:
        for c in range(C):
            if rng.uniform() < 0.5:
                zoom = rng.uniform(*cfg.lowres_zoom)
                # anisotropic patches keep full through-plane resolution:
                # nnU-Net passes ignore_axes=(0,) to SimulateLowResolution
                # when do_dummy_2d is on
                factors = [zoom] * data[c].ndim
                if cfg.dummy_2d and data[c].ndim == 3:
                    factors[0] = 1.0
                small = ndimage.zoom(data[c], factors, order=0)
                data[c] = _zoom_to(small, data[c].shape, order=3)
    for inverted, p in ((True, cfg.p_gamma_invert), (False, cfg.p_gamma)):
        if rng.uniform() < p:
            for c in range(C):
                data[c] = _gamma_channel(
                    data[c], cfg.gamma_range, inverted, rng
                )
    return data.astype(np.float32)


def _zoom_to(x: np.ndarray, shape, order: int) -> np.ndarray:
    factors = [t / s for t, s in zip(shape, x.shape)]
    out = ndimage.zoom(x, factors, order=order)
    # guard off-by-one from float rounding
    slices = tuple(slice(0, t) for t in shape)
    if out.shape != tuple(shape):
        pad = [(0, max(0, t - o)) for t, o in zip(shape, out.shape)]
        out = np.pad(out, pad, mode="edge")[slices]
    return out


def augment_sample(
    data, seg, cfg: AugmentConfig, rng: np.random.Generator, prev=None
):
    """data (C, *sp) float32, seg (*sp) int -> augmented tuple.

    ``prev`` (cascade: previous-stage seg, (*sp) int) rides through the same
    spatial transforms and mirrors as ``seg`` (order 0, no intensity) —
    nnU-Net treats it as an extra segmentation channel during DA."""
    if prev is None:
        data, seg = _spatial(data, seg, cfg, rng)
    else:
        stacked = np.stack([seg.astype(np.int16), prev.astype(np.int16)])
        # transform both label maps with one shared affine by flattening
        # them into a combined code (both are small non-negative ints)
        code = stacked[0].astype(np.int32) * 32768 + stacked[1]
        data, code = _spatial(data, code, cfg, rng)
        seg, prev = code // 32768, code % 32768
    data = _intensity(data.copy(), cfg, rng)
    if cfg.mirror_axes:
        for ax in cfg.mirror_axes:
            if rng.uniform() < 0.5:
                data = np.flip(data, axis=ax + 1)
                seg = np.flip(seg, axis=ax)
                if prev is not None:
                    prev = np.flip(prev, axis=ax)
    return (
        np.ascontiguousarray(data),
        np.ascontiguousarray(seg),
        None if prev is None else np.ascontiguousarray(prev),
    )


def augment_batch(
    data, seg, cfg: AugmentConfig, rng: np.random.Generator, prev=None
):
    """data (B, C, *sp), seg (B, *sp), optional prev (B, *sp).

    With ``cfg.final_patch_size`` set, inputs arrive at the initial
    (larger) size and outputs are the final size."""
    sp_out = (
        tuple(cfg.final_patch_size)
        if cfg.final_patch_size is not None
        and tuple(seg.shape[1:]) != tuple(cfg.final_patch_size)
        else seg.shape[1:]
    )
    out_d = np.empty((*data.shape[:2], *sp_out), data.dtype)
    out_s = np.empty((seg.shape[0], *sp_out), seg.dtype)
    out_p = (
        None if prev is None else np.empty((prev.shape[0], *sp_out), prev.dtype)
    )
    for b in range(data.shape[0]):
        p = None if prev is None else prev[b]
        out_d[b], out_s[b], pb = augment_sample(data[b], seg[b], cfg, rng, p)
        if out_p is not None:
            out_p[b] = pb
    return out_d, out_s, out_p


def cascade_onehot_noise(
    onehot: np.ndarray,
    rng: np.random.Generator,
    p_binary_op: float = 0.4,
    p_remove_component: float = 0.2,
    max_component_frac: float = 0.15,
) -> np.ndarray:
    """DA noise on the one-hot previous-stage channels (nnU-Net's
    ApplyRandomBinaryOperator + RemoveRandomConnectedComponent transforms):
    per channel, randomly dilate/erode/open/close with a random structuring
    element, and occasionally delete a small connected component — so the
    fullres net learns not to blindly trust the lowres prediction."""
    ops = (
        ndimage.binary_dilation,
        ndimage.binary_erosion,
        ndimage.binary_opening,
        ndimage.binary_closing,
    )
    out = onehot
    for c in range(out.shape[0]):
        if rng.uniform() < p_binary_op:
            op = ops[rng.integers(len(ops))]
            size = int(rng.integers(1, 8))
            strel = ndimage.generate_binary_structure(out[c].ndim, 1)
            strel = ndimage.iterate_structure(strel, max(1, size // 2))
            out[c] = op(out[c] > 0.5, structure=strel).astype(out.dtype)
        if rng.uniform() < p_remove_component:
            labeled, n = ndimage.label(out[c] > 0.5)
            if n:
                sizes = ndimage.sum_labels(
                    np.ones_like(labeled), labeled, index=np.arange(1, n + 1)
                )
                small = np.where(sizes / out[c].size < max_component_frac)[0]
                if len(small):
                    kill = int(small[rng.integers(len(small))]) + 1
                    out[c] = np.where(labeled == kill, 0, out[c])
    return out
