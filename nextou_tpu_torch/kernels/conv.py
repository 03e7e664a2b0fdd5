"""The tap-list 3D convolution: K5, its plain version and its dispatcher.
Counterpart of ``nextou_tpu/kernels/conv.py``.

A symmetric-padded 3D conv (pad ``(k - 1) // 2`` per axis, kernel dims in
{1, 3}, strides in {1, 2}) as a sum over its real taps only: a strided conv
multiplies no zero weight. The sum is kept in f32 and rounded once, to the
input's dtype; no bias. The network switches it on with ``conv_kernel``
(``nn/conv_blocks.py``) for the convs of :func:`conv_kernel_wins`.

Layout: channels-first, as the port's conv stages run. ``x`` is
``(B, C, D, H, W)`` and ``w`` is a ``Conv3d`` module's own weight
``(Co, C, kd, kh, kw)``; the JAX kernel takes ``(B, D, H, W, C)`` and
``(kd, kh, kw, C, Co)``, which is a transpose away.

- K5 :func:`conv3d_cuda` (``csrc/conv3d.cu``): the kernel, for bf16 the
  wgmma implicit GEMM of ``csrc/conv_sm90.cuh`` and for f32 FMAs; it reads
  and writes NCDHW directly, with no padded copy and no layout pass around
  it. :func:`conv_sm90_plan` mirrors the bf16 kernel's plan (its M block, N
  tiles, K granules, channels per stage, stages, staging route, CTAs and
  shared memory) and :func:`pack_weights_sm90` its weight packing; T3's
  channels-last kernel (``tools/exp_conv_kernel.py``) shares both.
- :func:`conv3d_reference`: its plain PyTorch version, the same sum over
  taps of shifted strided slices. The tests and CPU tensors use it.
- :class:`Conv3dKernel` joins the forward to the library conv's backward,
  as the JAX kernel's ``custom_vjp`` runs its backward through XLA's conv:
  the gradients are those of the path without the kernel.
- :func:`conv3d` dispatches on the tensor's device: a CPU tensor goes to the
  plain forward, a CUDA tensor to K5, or raises. There is no fallback from
  the kernel to the plain version or to the library conv.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from nextou_tpu_torch.kernels.build import check_tensors, library, ptr
from nextou_tpu_torch.trace import count

_DTYPES = (torch.bfloat16, torch.float32)


def _geometry(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int]):
    """``(kernel, stride, pads, out_spatial)`` of the conv, or ``ValueError``
    for what the kernel does not compute."""
    if x.dim() != 5 or w.dim() != 5 or x.shape[1] != w.shape[1]:
        raise ValueError(f"conv3d: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit "
                         "(B, C, D, H, W) and (Co, C, kd, kh, kw)")
    kernel, stride = tuple(w.shape[2:]), tuple(int(s) for s in stride)
    if len(stride) != 3 or any(k not in (1, 3) for k in kernel) or any(s not in (1, 2) for s in stride):
        raise ValueError(f"conv3d: kernel {kernel} / stride {stride}; takes kernel dims "
                         "in {1, 3} and strides in {1, 2}")
    pads = tuple((k - 1) // 2 for k in kernel)
    out = tuple((n + 2 * p - k) // s + 1 for n, p, k, s in zip(x.shape[2:], pads, kernel, stride))
    return kernel, stride, pads, out


def conv3d_reference(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int]) -> torch.Tensor:
    """Plain version of K5: for each tap ``(kd, kh, kw)`` the slice of the
    zero-padded input at positions ``s * o + t`` (that is ``s * o + t - k // 2``
    of the input itself), times ``w[:, :, kd, kh, kw]``, summed in f32 and
    cast to ``x.dtype``. Differentiable by autograd."""
    kernel, (sd, sh, sw), (pd, ph, pw), (Do, Ho, Wo) = _geometry(x, w, stride)
    xp = F.pad(x.float(), (pw, pw, ph, ph, pd, pd))
    wf = w.float()
    acc = torch.zeros((x.shape[0], w.shape[0], Do, Ho, Wo), dtype=torch.float32, device=x.device)
    for a, b, c in itertools.product(*(range(k) for k in kernel)):
        tap = xp[:, :, a: a + (Do - 1) * sd + 1: sd, b: b + (Ho - 1) * sh + 1: sh,
                 c: c + (Wo - 1) * sw + 1: sw]
        acc = acc + torch.einsum("bcdhw,oc->bodhw", tap, wf[:, :, a, b, c])
    return acc.to(x.dtype)


# --- the bf16 kernel's plan: csrc/conv_sm90.cuh::conv_sm90_plan, mirrored ---------------

SM90_TM = 128  # output positions per CTA: two consumer warpgroups of 64
SM90_MAX_STAGES = 4
SM90_SMEM_LIMIT = 232_448  # 227 KB of dynamic shared memory a block
SM90_RESERVED = 2048  # the barriers, a zero granule and the granule tables
SM90_N_WIDTHS = (40, 72, 136, 168)  # the instantiated wgmma widths
SM90_CS_CHOICES = (64, 32, 16, 8)  # input channels per stage, largest first
PLAN_KEYS = ("th", "tw", "n", "n_tiles", "granules", "cs", "stages", "splits", "route",
             "chunks", "ctas", "smem", "k_steps", "scratch")
ROUTES = ("regs", "cp16", "cp4", "vec")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align128(v: int) -> int:
    return (v + 127) // 128 * 128


def sm90_c_pad(C: int, cs: int) -> int:
    """C padded for chunks of ``cs`` channels: to a multiple of 8 (a
    granule), but to 16 where C <= 32 and a chunk holds 16 or more, so that
    each k16 step takes one tap's 16 channels as the library conv's steps do
    (the f32 sums of a narrow conv then round alike)."""
    return _cdiv(C, 16) * 16 if C <= 32 and cs >= 16 else _cdiv(C, 8) * 8


def conv_sm90_plan(layout: str, B: int, C: int, spatial, Co: int, kernel, stride) -> dict:
    """How the bf16 conv kernel runs a conv, as ``conv_sm90_plan`` in
    ``csrc/conv_sm90.cuh`` computes it. ``layout`` is ``"ncdhw"`` (K5:
    output extents ``(n + 2p - k) // s + 1``) or ``"ndhwc"`` (T3: ``n // s``).

    The keys of :data:`PLAN_KEYS`: the M block of ``th`` output rows x
    ``tw`` columns of one (batch, output depth); ``n_tiles`` N tiles of
    width ``n``; ``granules`` of K (taps x C / 8, C padded as
    :func:`sm90_c_pad` says); ``cs`` input channels per stage in ``chunks``
    chunks through a ring of ``stages`` (at least two); ``splits`` of K
    across CTAs (1: none); the halo's staging ``route`` (:data:`ROUTES`: 0
    through registers a granule at a time, 1 by 16-byte cp.async, 2 by 4-byte cp.async, 3 through
    registers 8 columns at a time, 16-byte loads transposed: K5 where W % 8
    == 0); ``ctas``, the output blocks (the launch runs min(ctas, SMs)
    persistent CTAs that walk them); ``smem`` bytes per CTA;
    ``k_steps`` k16 steps per block; ``scratch`` bytes of packed weights.
    Also ``out`` (the output extents), ``n_ht`` and ``n_wt`` (blocks per
    plane), ``gpc_last`` (granules per tap of the last chunk) and ``q2_full``
    / ``q2_last`` (granule slots of a full and of the last chunk, even).
    """
    (D, H, W), (kd, kh, kw), (sd, sh, sw) = spatial, kernel, stride
    taps = kd * kh * kw
    if layout == "ncdhw":
        out = tuple((n + 2 * ((k - 1) // 2) - k) // s + 1
                    for n, k, s in zip(spatial, kernel, stride))
    elif layout == "ndhwc":
        out = tuple(n // s for n, s in zip(spatial, stride))
    else:
        raise ValueError(f"conv_sm90_plan: layout {layout!r}")
    Do, Ho, Wo = out
    if min(out) < 1:
        raise ValueError(f"conv_sm90_plan: no output for {tuple(spatial)} under {tuple(stride)}")
    n_tiles = _cdiv(Co, SM90_N_WIDTHS[-1])
    need = _cdiv(_cdiv(Co, n_tiles), 8) * 8
    n = next(w for w in SM90_N_WIDTHS if w >= need)
    epilogue = _align128(n * (SM90_TM + 8) * 2 if layout == "ncdhw" else SM90_TM * (n + 8) * 2)
    tw = min(Wo, 32)
    # the largest block (th rows, from min(128 / tw, Ho) down) at which some
    # chunk leaves room for a ring of two stages; at it, first one chunk of
    # 16 channels a tap where C <= 32, then the largest chunk with room for
    # three stages, then the largest with room for two
    for th in range(min(SM90_TM // tw, Ho), 0, -1):
        in_rows, in_cols = (th - 1) * sh + kh, (tw - 1) * sw + kw
        n_pos = kd * in_rows * (in_cols if sw == 1 else 2 * _cdiv(in_cols, 2))
        fits = []
        for cs in SM90_CS_CHOICES:
            c_pad = sm90_c_pad(C, cs)
            if cs > 8 and cs // 2 >= c_pad:
                continue
            stage = _align128(2 * _cdiv(taps * (cs // 8), 2) * n * 16) + _align128(n_pos * cs * 2)
            fit = min(SM90_MAX_STAGES, (SM90_SMEM_LIMIT - SM90_RESERVED - epilogue) // stage)
            if fit >= 2:
                one_tap_steps = C <= 32 and cs == c_pad >= 16
                fits.append(((not one_tap_steps, fit < 3), cs, fit, c_pad, stage))
        if fits:
            break
    if not fits:
        raise ValueError(f"conv_sm90_plan: no stage fits for C {C}, Co {Co}, kernel {kernel}")
    _, cs, stages, c_pad, stage = min(fits, key=lambda f: f[0])
    chunks = _cdiv(c_pad, cs)
    gpc_last = (c_pad - (chunks - 1) * cs) // 8
    q2_full, q2_last = 2 * _cdiv(taps * cs // 8, 2), 2 * _cdiv(taps * gpc_last, 2)
    n_ht, n_wt = _cdiv(Ho, th), _cdiv(Wo, tw)
    scratch = ((chunks - 1) * q2_full + q2_last) * n * 16 * n_tiles
    if max(scratch, B * Do * n_ht * n_wt * n_tiles) > 0x7FFFFFFF:
        raise ValueError(f"conv_sm90_plan: {B}x{tuple(spatial)} x {C} -> {Co} overflows 32 bits")
    return {
        "th": th, "tw": tw, "n": n, "n_tiles": n_tiles, "granules": taps * c_pad // 8, "cs": cs,
        "stages": stages, "splits": 1,
        "route": ((3 if W % 8 == 0 else 0) if layout == "ncdhw"
                  else 0 if C % 2 else 1 if C % 8 == 0 else 2),
        "chunks": chunks,
        "ctas": B * Do * n_ht * n_wt * n_tiles,
        "smem": SM90_RESERVED + epilogue + stages * stage,
        "k_steps": ((chunks - 1) * q2_full + q2_last) // 2,
        "scratch": scratch,
        "out": out, "n_ht": n_ht, "n_wt": n_wt, "gpc_last": gpc_last,
        "q2_full": q2_full, "q2_last": q2_last,
    }


def describe_plan(plan: dict) -> str:
    """One line of a plan, for the tools' and the smoke run's output."""
    return (f"plan: block {plan['th']}x{plan['tw']}, N {plan['n_tiles']} x {plan['n']}, "
            f"{plan['granules']} granules, {plan['chunks']} chunks of {plan['cs']} channels "
            f"through {plan['stages']} stages, route {ROUTES[plan['route']]}, split-K "
            f"{plan['splits']}, {plan['ctas']} blocks, {plan['smem']} B smem, "
            f"{plan['k_steps']} k steps")


def library_plan(lib_name: str, args: tuple, device: torch.device | None = None) -> dict:
    """The plan as the library computes it (``{lib_name}_plan(*args)``) for
    ``device``, the current card by default (the plan reads its SM count):
    the :data:`PLAN_KEYS`. Raises where the shape has none."""
    index = torch.cuda.current_device() if device is None else torch.device(device).index
    return dict(_library_plan(lib_name, tuple(int(a) for a in args), index))


@functools.cache
def _library_plan(lib_name: str, args: tuple, device: int) -> tuple:
    out = (ctypes.c_int * len(PLAN_KEYS))()
    plan = getattr(library(lib_name), f"{lib_name}_plan")
    with torch.cuda.device(device):
        rc = plan(*args, ctypes.cast(out, ctypes.c_void_p))
    if rc != 0:
        raise ValueError(f"{lib_name}_plan{args}: no plan (CUDA error {rc})")
    return tuple(zip(PLAN_KEYS, out))


def pack_weights_sm90(wt: torch.Tensor, plan: dict) -> torch.Tensor:
    """The weights as the bf16 kernel stages them, from ``wt (taps, C,
    Co)``: ``(n_tiles, granule slots, n, 8)``, chunk after chunk; slot ``q``
    of a chunk is tap ``q // gpc`` and channels ``8 (q % gpc) .. + 7`` of the
    chunk (``gpc`` its granules per tap), zero past the taps, C and Co. The
    counterpart of ``pack_weights_kernel``, whose bytes the card test holds
    equal to it."""
    taps, C, Co = wt.shape
    n, cs, chunks = plan["n"], plan["cs"], plan["chunks"]
    tap_i, c_i, valid = [], [], []
    for k in range(chunks):
        last = k == chunks - 1
        gpc = plan["gpc_last"] if last else cs // 8
        q = np.arange(plan["q2_last"] if last else plan["q2_full"])
        c = k * cs + (q % gpc)[:, None] * 8 + np.arange(8)[None, :]
        tap = np.broadcast_to((q // gpc)[:, None], c.shape)
        tap_i.append(tap)
        c_i.append(c)
        valid.append((tap < taps) & (c < C))
    tap_i, c_i, valid = (np.concatenate(a) for a in (tap_i, c_i, valid))
    co = np.arange(plan["n_tiles"] * n).reshape(plan["n_tiles"], n)
    ok = torch.from_numpy(valid[None, :, None, :] & (co < Co)[:, None, :, None])
    g = wt[torch.from_numpy(np.minimum(tap_i, taps - 1))[None, :, None, :],
           torch.from_numpy(np.minimum(c_i, C - 1))[None, :, None, :],
           torch.from_numpy(np.minimum(co, Co - 1))[:, None, :, None]]
    return torch.where(ok.to(wt.device), g, torch.zeros((), dtype=wt.dtype, device=wt.device))


def conv3d_cuda(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int]) -> torch.Tensor:
    """Launch K5 on ``x (B, C, D, H, W)`` and ``w (Co, C, kd, kh, kw)``, both
    bf16 or both f32, contiguous, on one CUDA device. Returns
    ``(B, Co, Do, Ho, Wo)`` in ``x.dtype``.

    The counter ``k5.launches`` (``trace.py``) counts the launches.
    """
    kernel, stride, _, out_spatial = _geometry(x, w, stride)
    B, C = x.shape[:2]
    Co = w.shape[0]
    dev = check_tensors(
        "conv3d_cuda", {"x": x, "w": w}, {"x": _DTYPES, "w": (x.dtype,)},
        {"x": x.shape, "w": (Co, C, *kernel)},
    )
    out = torch.empty((B, Co, *out_spatial), dtype=x.dtype, device=dev)
    lib = library("conv3d")
    bf16 = int(x.dtype == torch.bfloat16)
    scratch = None
    if bf16:  # the bf16 kernel reads the weights packed; it packs them itself
        plan = library_plan("conv3d", (B, C, *x.shape[2:], Co, *kernel, *stride), dev)
        scratch = torch.empty(plan["scratch"], dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.conv3d_forward(
            ptr(x), ptr(w), ptr(out), ptr(scratch), B, C, *x.shape[2:], Co, *kernel, *stride,
            bf16, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv3d_cuda: launch failed with CUDA error {rc}")
    count("k5.launches")
    return out



class Conv3dKernel(torch.autograd.Function):
    """K5 forward (the plain version on a CPU tensor), the library conv's
    backward: the counterpart of ``pallas_conv``'s ``custom_vjp``.

    ``apply(x, w, stride)``. The backward hands the saved ``(x, w)`` and the
    cotangent, cast to ``x.dtype``, to ``aten.convolution_backward``, which is
    what differentiating ``F.conv3d`` calls: the gradients are the library
    conv's for the same cotangent (bit-equal on the CPU; on the card as far
    as two calls of cuDNN's backward are).
    """

    @staticmethod
    def forward(ctx, x, w, stride):
        ctx.save_for_backward(x, w)
        ctx.stride = tuple(stride)
        if x.device.type == "cuda":
            return conv3d_cuda(x.contiguous(), w.contiguous(), stride)
        return conv3d_reference(x, w, stride)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        pads = [(k - 1) // 2 for k in w.shape[2:]]
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g.to(x.dtype), x, w, None, list(ctx.stride), pads, [1, 1, 1], False, [0, 0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False],
        )
        return gx, gw, None


def conv3d(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """Channels-first symmetric-padded conv through K5.

    Args:
        x: ``(B, C, D, H, W)``.
        w: ``(Co, C, kd, kh, kw)`` in ``x.dtype``, kernel dims in {1, 3}.
        stride: per axis, each 1 or 2.
    Returns:
        ``(B, Co, Do, Ho, Wo)`` in ``x.dtype``, equal to ``F.conv3d`` with
        padding ``(k - 1) // 2`` up to the order of the f32 sum.

    A CPU tensor takes the plain forward, a CUDA tensor K5; a failed build
    or launch raises. The backward is the library conv's either way.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise NotImplementedError(f"conv3d on {x.device.type}")
    return Conv3dKernel.apply(x, w, tuple(stride))


def conv_kernel_wins(in_spatial, C: int, Co: int, kernel, stride) -> bool:
    """The convs the network hands to K5 when ``conv_kernel`` is on: the
    region of ``pallas_conv_wins`` in the JAX package, carried over as
    geometry. (3, 3, 3) kernels whose strides divide the input extent, an
    even number of output rows and at least 48 output columns, an input of
    at least 64 x 96 x 112 voxels and at most 192 channels on either side:
    on the flagship the strided encoder convs e1a and e2a and the stride-1
    convs e1b, d1a and d1b."""
    if tuple(kernel) != (3, 3, 3):
        return False
    if any(s % st for s, st in zip(in_spatial, stride)):
        return False
    out_sp = [s // st for s, st in zip(in_spatial, stride)]
    if out_sp[1] % 2 or out_sp[2] < 48:
        return False
    return math.prod(in_spatial) >= 64 * 96 * 112 and max(C, Co) <= 192


def every_333_conv(in_spatial, C: int, Co: int, kernel, stride) -> bool:
    """A region wider than :func:`conv_kernel_wins`'s: every (3, 3, 3) conv.
    Set in its place in ``nn.conv_blocks`` (as the conv tests and
    ``chip_smoke.py`` do), it lets a network too small for the region run
    K5 at each such conv."""
    return tuple(kernel) == (3, 3, 3)
