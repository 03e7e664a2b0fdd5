"""The training batches, worked out again: nnU-Net's patch sampling with
foreground oversampling and its default augmentation, in NumPy and
``scipy.ndimage``, from the same generator seeds as the trainer's loader
threads and in the same draw order.

Loader thread ``t`` draws from ``default_rng(seed + 1000 t)``; batches are
served from the threads in turn, so batch ``j`` is thread ``j % T``'s
``(j // T)``-th. A batch draws, per sample, a case, a patch centre
(the trailing third forced onto a foreground voxel of a random class), then
per sample the augmentation: rotation and scaling (sample-larger-then-crop),
noise, blur, brightness, contrast, simulated low resolution, gamma
(inverted, then plain), mirroring, with nnU-Net's probabilities.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy import ndimage


@dataclasses.dataclass
class Aug:
    rotation: tuple
    dummy_2d: bool
    mirror_axes: tuple
    final: tuple
    p_rotation: float = 0.2
    scale_range: tuple = (0.7, 1.4)
    p_scaling: float = 0.2
    p_noise: float = 0.1
    noise_variance: tuple = (0.0, 0.1)
    p_blur: float = 0.2
    blur_sigma: tuple = (0.5, 1.0)
    p_brightness: float = 0.15
    brightness_range: tuple = (0.75, 1.25)
    p_contrast: float = 0.15
    contrast_range: tuple = (0.75, 1.25)
    p_lowres: float = 0.25
    lowres_zoom: tuple = (0.5, 1.0)
    p_gamma_invert: float = 0.1
    p_gamma: float = 0.3
    gamma_range: tuple = (0.7, 1.5)


def aug_for_patch(patch) -> Aug:
    """nnU-Net's rule: 2D rotates by up to 180 degrees (15 where the patch's
    aspect exceeds 1.5); 3D by 30 per axis, or in-plane only by 180 where the
    patch is over 3 times longer in-plane than deep (dummy 2D)."""
    patch = tuple(patch)
    if len(patch) == 2:
        rot, dummy = ((np.pi / 12.0,) if max(patch) / min(patch) > 1.5 else (np.pi,)), False
    else:
        dummy = max(patch) / patch[0] > 3
        rot = (np.pi,) * 3 if dummy else (np.pi / 6.0,) * 3
    return Aug(rotation=rot, dummy_2d=dummy, mirror_axes=tuple(range(len(patch))), final=patch)


def initial_patch_size(final, rotation, dummy_2d, scale_range=(0.7, 1.4)) -> tuple:
    """batchgenerators' ``get_patch_size``: the final extent rotated by each
    largest angle (capped at 90 degrees), the componentwise max, over the
    smallest scale, rounded to an even margin."""
    final = np.asarray(final, np.float64)
    dim = len(final)
    rots = list(rotation) + [rotation[-1]] * (dim - len(rotation))
    rots = [min(np.pi / 2.0, abs(r)) for r in rots]
    if dummy_2d and dim == 3:
        return (int(final[0]), *initial_patch_size(final[1:], rots[:1], False, scale_range))
    extent = final.copy()
    pairs = ((1, 2), (0, 2), (0, 1)) if dim == 3 else ((0, 1),)
    for (i, j), ang in zip(pairs, rots):
        r = np.eye(dim)
        r[i, i], r[i, j], r[j, i], r[j, j] = np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)
        extent = np.maximum(extent, np.abs(r @ final))
    out = []
    for e, f in zip(extent / min(scale_range), final):
        n = int(np.round(e))
        n += (n - int(f)) % 2
        out.append(max(n, int(f)))
    return tuple(out)


# --- sampling ---------------------------------------------------------------------------


def _patch(data, seg, center, size):
    lo = center - np.array(size) // 2
    src_lo, src_hi = np.maximum(lo, 0), np.minimum(lo + size, seg.shape)
    d = np.zeros((data.shape[0], *size), np.float32)
    s = np.zeros(tuple(size), np.int16)
    src = tuple(slice(a, b) for a, b in zip(src_lo, src_hi))
    dst = tuple(slice(a - l, b - l) for a, b, l in zip(src_lo, src_hi, lo))
    d[(slice(None),) + dst] = data[(slice(None),) + src]
    s[dst] = seg[src]
    return d, s


def sample_batch(cases: list, size, batch: int, oversample: float, rng):
    """``cases``: ``(data (C, *sp), seg (*sp), {class: (n, d) locations})``."""
    n_fg = round(batch * oversample)
    datas, segs = [], []
    size = np.array(size)
    for i in range(batch):
        data, seg, locs = cases[rng.integers(len(cases))]
        if i >= batch - n_fg and locs:
            cls = rng.choice(list(locs.keys()))
            center = locs[cls][rng.integers(len(locs[cls]))].astype(np.int64)
        else:
            sp = np.array(seg.shape)
            lo = np.minimum(size // 2, sp // 2)
            hi = np.maximum(sp - size + size // 2, lo)
            center = np.array([rng.integers(a, b + 1) for a, b in zip(lo, hi)], np.int64)
        d, s = _patch(data, seg, center, size)
        datas.append(d)
        segs.append(s)
    return np.stack(datas), np.stack(segs)


# --- augmentation -----------------------------------------------------------------------


def _rotation(cfg: Aug, dim, rng):
    mat = np.eye(dim)
    if dim == 3 and cfg.dummy_2d:
        ang = rng.uniform(-cfg.rotation[0], cfg.rotation[0])
        r = np.eye(3)
        r[1, 1], r[1, 2], r[2, 1], r[2, 2] = np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)
        return mat @ r
    if dim == 3:
        angles = [rng.uniform(-a, a) for a in cfg.rotation[:3]]
        for (i, j), ang in zip(((1, 2), (0, 2), (0, 1)), angles):
            r = np.eye(3)
            r[i, i], r[i, j], r[j, i], r[j, j] = np.cos(ang), -np.sin(ang), np.sin(ang), np.cos(ang)
            mat = mat @ r
        return mat
    ang = rng.uniform(-cfg.rotation[0], cfg.rotation[0])
    return mat @ np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])


def _spatial(data, seg, cfg: Aug, rng):
    final = tuple(cfg.final)
    dim = seg.ndim
    origin = np.array([(s - f) // 2 for s, f in zip(seg.shape, final)])
    crop = tuple(slice(o, o + f) for o, f in zip(origin, final))
    do_rot, do_scale = rng.uniform() < cfg.p_rotation, rng.uniform() < cfg.p_scaling
    if not (do_rot or do_scale):
        return data[(slice(None),) + crop], seg[crop]
    mat = _rotation(cfg, dim, rng) if do_rot else np.eye(dim)
    if do_scale:
        scale = rng.uniform(*cfg.scale_range)
        mat = mat @ np.diag([1.0, scale, scale]) if (dim == 3 and cfg.dummy_2d) else mat * scale
    center = (np.array(seg.shape) - 1) / 2.0
    # resample only the centre crop: output index o reads mat (o + origin) + offset
    offset = center - mat @ center + mat @ origin
    out_d = np.stack([ndimage.affine_transform(c, mat, offset, final, order=1, mode="reflect")
                      for c in data])
    out_s = ndimage.affine_transform(seg.astype(np.float32), mat, offset, final, order=0,
                                     mode="constant", cval=0.0).astype(seg.dtype)
    return out_d, out_s


def _zoom_to(x, shape, order):
    out = ndimage.zoom(x, [t / s for t, s in zip(shape, x.shape)], order=order)
    if out.shape != tuple(shape):
        out = np.pad(out, [(0, max(0, t - o)) for t, o in zip(shape, out.shape)], mode="edge")
        out = out[tuple(slice(0, t) for t in shape)]
    return out


def _gamma(x, cfg: Aug, inverted, rng):
    mean_stat, sd_stat = x.mean(), x.std()
    lo, hi = cfg.gamma_range
    if rng.uniform() < 0.5 and lo < 1:
        gamma = rng.uniform(lo, 1.0)
    else:
        gamma = rng.uniform(max(lo, 1.0), hi)
    mn, span = x.min(), np.ptp(x)
    t = (x - mn) / (span + 1e-7)
    t = 1.0 - (1.0 - t) ** gamma if inverted else t**gamma
    x = t * span + mn
    return (x - x.mean()) / (x.std() + 1e-8) * sd_stat + mean_stat


def _intensity(data, cfg: Aug, rng):
    C = data.shape[0]
    if rng.uniform() < cfg.p_noise:
        sd = rng.uniform(*cfg.noise_variance)
        data = data + rng.normal(0, sd, data.shape).astype(np.float32)
    if rng.uniform() < cfg.p_blur:
        for c in range(C):
            if rng.uniform() < 0.5:
                data[c] = ndimage.gaussian_filter(data[c], rng.uniform(*cfg.blur_sigma))
    if rng.uniform() < cfg.p_brightness:
        for c in range(C):
            data[c] = data[c] * rng.uniform(*cfg.brightness_range)
    if rng.uniform() < cfg.p_contrast:
        for c in range(C):
            f = rng.uniform(*cfg.contrast_range)
            mean, mn, mx = data[c].mean(), data[c].min(), data[c].max()
            data[c] = np.clip((data[c] - mean) * f + mean, mn, mx)
    if rng.uniform() < cfg.p_lowres:
        for c in range(C):
            if rng.uniform() < 0.5:
                z = rng.uniform(*cfg.lowres_zoom)
                factors = [z] * data[c].ndim
                if cfg.dummy_2d and data[c].ndim == 3:
                    factors[0] = 1.0
                data[c] = _zoom_to(ndimage.zoom(data[c], factors, order=0), data[c].shape, 3)
    for inverted, p in ((True, cfg.p_gamma_invert), (False, cfg.p_gamma)):
        if rng.uniform() < p:
            for c in range(C):
                data[c] = _gamma(data[c], cfg, inverted, rng)
    return data.astype(np.float32)


def augment(data, seg, cfg: Aug, rng):
    """One sample ``(C, *initial)``, ``(*initial)`` -> final size."""
    data, seg = _spatial(data, seg, cfg, rng)
    data = _intensity(np.array(data, np.float32), cfg, rng)
    for ax in cfg.mirror_axes:
        if rng.uniform() < 0.5:
            data, seg = np.flip(data, ax + 1), np.flip(seg, ax)
    return np.ascontiguousarray(data), np.ascontiguousarray(seg)


def batches(cases, cfg: Aug, batch: int, oversample: float, seed: int, threads: int, n: int):
    """The first ``n`` augmented batches of the loader: ``[(data (B, *final,
    C) f32, seg (B, *final) int64)]``."""
    rngs = [np.random.default_rng(seed + 1000 * t) for t in range(threads)]
    size = initial_patch_size(cfg.final, cfg.rotation, cfg.dummy_2d, cfg.scale_range)
    out = []
    for j in range(n):
        rng = rngs[j % threads]
        data, seg = sample_batch(cases, size, batch, oversample, rng)
        pairs = [augment(d, s, cfg, rng) for d, s in zip(data, seg)]
        out.append((np.moveaxis(np.stack([p[0] for p in pairs]), 1, -1),
                    np.stack([p[1] for p in pairs]).astype(np.int64)))
    return out
