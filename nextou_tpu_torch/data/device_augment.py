"""On-device augmentation: the host draws, the card transforms.

Counterpart of ``nextou_tpu/data/device_augment.py``, redesigned to equal
the host path (``data/augment.py``) rather than approximate it. Every random
draw of ``augment.py::augment_sample`` is independent of the voxels
(triggers, angles, scale, sigmas, factors, zooms, gamma sides, mirror
coins; the noise field's size is known), so a loader thread replays that
draw sequence from its own generator into a small per-sample
:class:`AugmentPlan` (:func:`draw_augment_plan`) and the tensor's device
applies it to the raw initial-size patch (:func:`device_augment_batch`).
For one seed the batch equals the host path's within float rounding, and
the generator ends where ``augment_sample`` leaves it.

Where the JAX device path differs from the host path, this port follows the
host path:

- it samples the larger :func:`~nextou_tpu_torch.data.augment.initial_patch_size`
  patch and evaluates only the final crop's voxels (sample-larger-then-crop),
  not a final-size patch rotated with reflect padding;
- coordinates are float64 and computed as the native resampler computes them
  (``native/resample.cpp::nxt_affine_f32``), so that order-0 labels fall on
  the same side of half-voxel ties; taps are explicit gathers with scipy's
  'reflect' (d c b a | a b c d) or clamped 'constant' indices, never
  ``grid_sample``;
- the simulated low resolution applies, per axis, the operator of scipy's
  nearest-downsample and cubic B-spline upsample (:func:`lowres_axis_operator`),
  not a Keys cubic;
- the draws come in the host path's order from a ``numpy`` generator.

A transform whose trigger did not fire costs nothing: the plan is on the
host and each transform sits behind a Python ``if``. A cascade keeps host
augmentation (its one-hot noise needs connected components on the host).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from scipy import ndimage

from nextou_tpu_torch.data.augment import AugmentConfig, _zoom_to


@dataclass
class AugmentPlan:
    """One sample's draws. ``None`` (or empty) where a transform did not
    fire; a per-channel list holds ``None`` for a channel whose coin lost."""

    in_shape: tuple[int, ...]  # spatial shape of the sampled patch
    out_shape: tuple[int, ...]  # spatial shape after the center crop
    mat: np.ndarray | None = None  # rotation∘scale (dim, dim), float64
    offset: np.ndarray | None = None  # (dim,) float64
    noise: np.ndarray | None = None  # (C, *out_shape) float32
    blur: list | None = None  # per channel: sigma or None
    brightness: list | None = None  # per channel: factor
    contrast: list | None = None  # per channel: factor
    lowres: list | None = None  # per channel: zoom or None
    gamma: list = field(default_factory=list)  # [(inverted, per-channel gamma)]
    mirror: tuple[int, ...] = ()  # spatial axes to flip

    @property
    def crop_origin(self) -> tuple[int, ...]:
        """``augment.py::_center_crop``'s lower corner."""
        return tuple((s - f) // 2 for s, f in zip(self.in_shape, self.out_shape))


def _draw_matrix(cfg: AugmentConfig, dim: int, do_rot: bool, do_scale: bool,
                 rng: np.random.Generator) -> np.ndarray:
    """``augment.py::_spatial``'s rotation∘scale, drawn in its order."""
    mat = np.eye(dim)
    if do_rot:
        if dim == 3 and cfg.dummy_2d:
            ang = rng.uniform(-cfg.rotation_rad[0], cfg.rotation_rad[0])
            c, s = np.cos(ang), np.sin(ang)
            r = np.eye(3)
            r[1, 1], r[1, 2], r[2, 1], r[2, 2] = c, -s, s, c
            mat = mat @ r
        elif dim == 3:
            angles = [rng.uniform(-a, a) for a in cfg.rotation_rad[:3]]
            for (i, j), ang in zip(((1, 2), (0, 2), (0, 1)), angles):
                r = np.eye(3)
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
    return mat


def draw_augment_plan(cfg: AugmentConfig, in_shape, rng: np.random.Generator) -> AugmentPlan:
    """The draws of ``augment.py::augment_sample`` for a ``(C, *sp)`` patch,
    in its order and nothing else: afterwards ``rng`` is where
    ``augment_sample`` leaves it. Runs on the host, touches no voxel; the
    noise field (drawn whenever noise fires) ships with the plan."""
    C, *sp = (int(n) for n in in_shape)
    sp, dim = tuple(sp), len(sp)
    final = tuple(cfg.final_patch_size) if cfg.final_patch_size is not None else None
    if final is None or final == sp:
        final = sp  # no margin: rotate in place with reflection (augment.py::_spatial)
    plan = AugmentPlan(in_shape=sp, out_shape=final)

    do_rot = rng.uniform() < cfg.p_rotation
    do_scale = rng.uniform() < cfg.p_scaling
    if do_rot or do_scale:
        plan.mat = _draw_matrix(cfg, dim, do_rot, do_scale, rng)
        center = (np.array(sp) - 1) / 2.0
        plan.offset = center - plan.mat @ center

    if rng.uniform() < cfg.p_noise:
        sd = rng.uniform(*cfg.noise_variance)
        plan.noise = rng.normal(0, sd, (C, *final)).astype(np.float32)
    if rng.uniform() < cfg.p_blur:
        plan.blur = [rng.uniform(*cfg.blur_sigma) if rng.uniform() < 0.5 else None
                     for _ in range(C)]
    if rng.uniform() < cfg.p_brightness:
        plan.brightness = [rng.uniform(*cfg.brightness_range) for _ in range(C)]
    if rng.uniform() < cfg.p_contrast:
        plan.contrast = [rng.uniform(*cfg.contrast_range) for _ in range(C)]
    if rng.uniform() < cfg.p_lowres:
        plan.lowres = [rng.uniform(*cfg.lowres_zoom) if rng.uniform() < 0.5 else None
                       for _ in range(C)]
    lo, hi = cfg.gamma_range
    for inverted, p in ((True, cfg.p_gamma_invert), (False, cfg.p_gamma)):
        if rng.uniform() < p:
            gammas = []
            for _ in range(C):  # augment.py::_gamma_channel's two-sided draw
                if rng.uniform() < 0.5 and lo < 1:
                    gammas.append(rng.uniform(lo, 1.0))
                else:
                    gammas.append(rng.uniform(max(lo, 1.0), hi))
            plan.gamma.append((inverted, gammas))
    plan.mirror = tuple(ax for ax in cfg.mirror_axes if rng.uniform() < 0.5)
    return plan


# --------------------------------------------------------------------- #
# spatial resampling (scipy.ndimage.affine_transform, orders 0 and 1)
# --------------------------------------------------------------------- #


def _reflect_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """scipy 'reflect' (symmetric) extension: (d c b a | a b c d | d c b a).
    torch's ``F.pad(mode="reflect")`` is scipy's 'mirror' instead."""
    if n == 1:
        return torch.zeros_like(idx)
    idx = torch.remainder(idx, 2 * n)
    return torch.where(idx >= n, 2 * n - 1 - idx, idx)


def _input_coords(mat, offset, out_shape, out_origin, device) -> list[torch.Tensor]:
    """float64 input coordinates ``mat @ (o + out_origin) + offset`` of every
    output index ``o``, one tensor per axis, in the native resampler's
    arithmetic: ``(m[d,0] i0 + m[d,1] i1) + off[d]``, then ``+ m[d,2] i2``."""
    dim = len(out_shape)
    m = np.asarray(mat, np.float64).tolist()
    off = np.asarray(offset, np.float64).tolist()
    idx = [torch.arange(o, o + n, dtype=torch.float64, device=device).view(
        [n if a == ax else 1 for a in range(dim)])
        for ax, (o, n) in enumerate(zip(out_origin, out_shape))]
    coords = []
    for d in range(dim):
        c = (idx[0] * m[d][0] + idx[1] * m[d][1]) + off[d]
        if dim == 3:
            c = c + idx[2] * m[d][2]
        coords.append(c.expand(out_shape))
    return coords


def _gather(vol: torch.Tensor, taps: list[torch.Tensor], shape) -> torch.Tensor:
    """``vol[..., taps[0], taps[1], ...]`` for (*lead, *shape) ``vol``."""
    flat = taps[0]
    for t, n in zip(taps[1:], shape[1:]):
        flat = flat * n + t
    lead = vol.shape[: vol.ndim - len(shape)]
    return vol.reshape(*lead, -1)[..., flat.reshape(-1)].reshape(*lead, *flat.shape)


def affine_resample(vol: torch.Tensor, mat, offset, order: int, mode: str, cval: float = 0.0,
                    out_shape=None, out_origin=None) -> torch.Tensor:
    """``scipy.ndimage.affine_transform(vol, mat, offset, order=order,
    mode=mode, cval=cval)`` for orders 0 and 1, modes 'reflect' and
    'constant', on ``vol``'s device, evaluated only at the output indices
    ``out_origin + [0, out_shape)`` (default: the whole volume). ``vol`` is
    (*lead, *sp) with ``len(mat)`` spatial axes; the leading axes share the
    coordinates. ``mat`` and ``offset`` are host arrays (float64).

    In 'constant' mode the domain is the host path's
    (``native.affine_transform``): scipy's [0, n-1] at order 0, and at
    order 1 [-0.5, n-0.5] with the taps beyond the edge clamped to it, so
    the half-voxel shell at the edge takes the edge's values, not ``cval``."""
    dim = len(mat)
    shape = tuple(vol.shape[vol.ndim - dim:])
    out_shape = shape if out_shape is None else tuple(out_shape)
    out_origin = (0,) * dim if out_origin is None else tuple(out_origin)
    if mode not in ("reflect", "constant") or order not in (0, 1):
        raise ValueError(f"affine_resample: order {order}, mode {mode!r} not supported")
    coords = _input_coords(mat, offset, out_shape, out_origin, vol.device)
    const = mode == "constant"

    def tap(j, n):
        return j.clamp(0, n - 1) if const else _reflect_index(j, n)

    if order == 0:
        out = _gather(vol, [tap(torch.floor(c + 0.5).long(), n) for c, n in zip(coords, shape)],
                      shape)
    else:
        base = [torch.floor(c) for c in coords]
        f = [c - b for c, b in zip(coords, base)]
        g = [1.0 - x for x in f]
        lo = [b.long() for b in base]

        def corner(*bits):
            taps = [tap(lo[d] + bits[d], n) for d, n in enumerate(shape)]
            return _gather(vol, taps, shape).double()

        if dim == 3:  # nxt_affine_f32's interior expression, in its order
            v00 = g[2] * corner(0, 0, 0) + f[2] * corner(0, 0, 1)
            v01 = g[2] * corner(0, 1, 0) + f[2] * corner(0, 1, 1)
            v10 = g[2] * corner(1, 0, 0) + f[2] * corner(1, 0, 1)
            v11 = g[2] * corner(1, 1, 0) + f[2] * corner(1, 1, 1)
            out = g[0] * (g[1] * v00 + f[1] * v01) + f[0] * (g[1] * v10 + f[1] * v11)
        else:  # its corner loop (bit d of the corner picks axis d's upper tap)
            out = None
            for k in range(4):
                bits = (k & 1, (k >> 1) & 1)
                term = (f[0] if bits[0] else g[0]) * (f[1] if bits[1] else g[1]) * corner(*bits)
                out = term if out is None else out + term
        out = out.to(vol.dtype)
    if const:
        # the host path's domain on the unrounded coordinate
        # (native/resample.cpp): scipy's [0, n-1] at order 0, [-0.5, n-0.5]
        # at order 1, where the taps beyond the edge are clamped to it
        lo_edge, hi_edge = (0.0, 1.0) if order == 0 else (-0.5, 0.5)
        ok = torch.stack([(c >= lo_edge) & (c <= n - hi_edge)
                          for c, n in zip(coords, shape)]).all(0)
        out = torch.where(ok, out, torch.as_tensor(cval, dtype=vol.dtype, device=vol.device))
    return out


# --------------------------------------------------------------------- #
# Gaussian blur (scipy.ndimage.gaussian_filter: truncate 4, 'reflect')
# --------------------------------------------------------------------- #


def _gaussian_taps(sigma: float) -> list[float]:
    """scipy's normalized taps exp(-(i/σ)²/2), |i| <= int(4σ + 0.5), summed
    in order as the native resampler sums them; f32 values."""
    radius = int(4.0 * sigma + 0.5)
    k = [float(np.exp(-0.5 * (i / sigma) * (i / sigma))) for i in range(-radius, radius + 1)]
    total = 0.0
    for v in k:
        total += v
    return [float(np.float32(v / total)) for v in k]


def gaussian_blur(vol: torch.Tensor, sigma: float) -> torch.Tensor:
    """``scipy.ndimage.gaussian_filter(vol, sigma)`` (truncate 4.0,
    half-sample symmetric borders) over every axis of an f32 ``vol``,
    axis by axis, each tap added in f32 in the native resampler's order."""
    taps = _gaussian_taps(sigma)
    radius = len(taps) // 2
    out = vol
    for ax in range(vol.ndim):
        n = vol.shape[ax]
        idx = _reflect_index(torch.arange(-radius, n + radius, device=vol.device), n)
        padded = out.index_select(ax, idx)
        acc = padded.narrow(ax, 0, n) * taps[0]
        for t in range(1, len(taps)):
            acc = acc + padded.narrow(ax, t, n) * taps[t]
        out = acc
    return out


# --------------------------------------------------------------------- #
# simulated low resolution as per-axis operators
# --------------------------------------------------------------------- #


def lowres_axis_operator(n: int, zoom: float) -> np.ndarray:
    """(n, n) float64 operator of ``augment.py``'s round trip along one axis:
    ``_zoom_to(ndimage.zoom(x, zoom, order=0), n, order=3)`` (nearest
    downsample to ``round(n * zoom)`` samples, cubic B-spline upsample back,
    with ``_zoom_to``'s edge padding of an off-by-one shape). Both zooms are
    separable, so applying it along each axis in turn is the nd round trip.
    Built by scipy from the identity's columns."""
    eye = np.eye(n)
    small = ndimage.zoom(eye, (zoom, 1.0), order=0)
    return _zoom_to(small, (n, n), order=3)


def _apply_along(op: torch.Tensor, x: torch.Tensor, ax: int) -> torch.Tensor:
    return torch.movedim(torch.tensordot(op, x, dims=([1], [ax])), 0, ax)


def _lowres(x: torch.Tensor, zoom: float, skip_first: bool) -> torch.Tensor:
    y = x.double()
    for ax in range(int(skip_first), x.ndim):
        op = torch.from_numpy(lowres_axis_operator(x.shape[ax], zoom)).to(x.device)
        y = _apply_along(op, y, ax)
    return y.to(x.dtype)


# --------------------------------------------------------------------- #
# intensity transforms (augment.py::_intensity, f32)
# --------------------------------------------------------------------- #


def _stats(x: torch.Tensor):
    """Mean and population std as 0-d f32 tensors on the device (no sync)."""
    xd = x.double()
    return xd.mean().float(), xd.std(correction=0).float()


def _contrast(x: torch.Tensor, factor: float) -> torch.Tensor:
    mean = x.double().mean().float()
    return torch.clamp((x - mean) * factor + mean, x.min(), x.max())


def _gamma(x: torch.Tensor, gamma: float, inverted: bool) -> torch.Tensor:
    """``augment.py::_gamma_channel`` after its draw: retain_stats=True."""
    mean_stat, sd_stat = _stats(x)
    mn = x.min()
    rngv = x.max() - mn
    t = (x - mn) / (rngv + 1e-7)
    t = 1.0 - (1.0 - t) ** gamma if inverted else t**gamma
    x = t * rngv + mn
    mean, sd = _stats(x)
    return (x - mean) / (sd + 1e-8) * sd_stat + mean_stat


def _augment_sample(data: torch.Tensor, seg: torch.Tensor, plan: AugmentPlan,
                    cfg: AugmentConfig, prev: torch.Tensor | None):
    """data (C, *in) f32, seg (*in) int -> final-size (data, seg, prev)."""
    origin, out = plan.crop_origin, plan.out_shape
    if plan.mat is None:
        crop = tuple(slice(o, o + n) for o, n in zip(origin, out))
        data, seg = data[(slice(None), *crop)], seg[crop]
        prev = None if prev is None else prev[crop]
    else:
        def labels(s):
            return affine_resample(s, plan.mat, plan.offset, 0, "constant", 0, out, origin)
        data = affine_resample(data, plan.mat, plan.offset, 1, "reflect", 0.0, out, origin)
        seg = labels(seg)
        prev = None if prev is None else labels(prev)

    channels = list(data.unbind(0))
    if plan.noise is not None:
        noise = torch.from_numpy(plan.noise).to(data.device)
        channels = [x + n for x, n in zip(channels, noise.unbind(0))]
    if plan.blur is not None:
        channels = [x if s is None else gaussian_blur(x, s) for x, s in zip(channels, plan.blur)]
    if plan.brightness is not None:
        channels = [x * f for x, f in zip(channels, plan.brightness)]
    if plan.contrast is not None:
        channels = [_contrast(x, f) for x, f in zip(channels, plan.contrast)]
    if plan.lowres is not None:
        # anisotropic patches keep their through-plane resolution (dummy 2D)
        skip = cfg.dummy_2d and len(out) == 3
        channels = [x if z is None else _lowres(x, z, skip) for x, z in zip(channels, plan.lowres)]
    for inverted, gammas in plan.gamma:
        channels = [_gamma(x, g, inverted) for x, g in zip(channels, gammas)]
    data = torch.stack(channels)
    if plan.mirror:
        data = torch.flip(data, [ax + 1 for ax in plan.mirror])
        seg = torch.flip(seg, list(plan.mirror))
        prev = None if prev is None else torch.flip(prev, list(plan.mirror))
    return data, seg, prev


def device_augment_batch(data: torch.Tensor, seg: torch.Tensor, plans, cfg: AugmentConfig,
                         prev: torch.Tensor | None = None):
    """Apply one :class:`AugmentPlan` per sample on the tensors' device:
    data (B, C, *in) f32, seg and prev (B, *in) int -> (data (B, C, *out),
    seg (B, *out), prev or None), ``augment.py::augment_batch``'s result
    for the same draws."""
    if len(plans) != data.shape[0]:
        raise ValueError(f"{len(plans)} plans for a batch of {data.shape[0]}")
    outs = [_augment_sample(data[b], seg[b], plan, cfg, None if prev is None else prev[b])
            for b, plan in enumerate(plans)]
    return (torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs]),
            None if prev is None else torch.stack([o[2] for o in outs]))
