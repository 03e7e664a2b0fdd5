"""The channels-last im2col conv (T3) on a CUDA card: check and time it.

    python -m nextou_tpu_torch.tools.exp_conv_kernel {check,bench,check3,bench3}

Counterpart of the JAX package's ``tools/exp_conv_kernel.py``, whose two
Pallas kernels (``pallas_conv``: an im2col slab per grid step and one MXU
matmul with K = taps x C, strides in {1, 2}; ``csub_conv``: the same conv at
stride 1 with the channels on the sublanes) are one CUDA kernel here,
``csrc/conv_cl.cu``. The public functions keep the JAX tool's layouts:
``x (N, D, H, W, C)``, ``w (kd, kh, kw, C, Co)``, symmetric ``(k - 1) // 2``
padding, and T3's output extents ``D // sd``, ``H // sh``, ``W // sw`` (for
an odd extent under a stride one output fewer than ``F.conv3d`` gives).

- :func:`conv_cl_reference`: the plain version, a sum over the taps of
  shifted strided slices in f32, rounded once to ``x``'s dtype.
- :func:`conv_cl_cuda`: the kernel, with a ``launches`` count; it refuses a
  tensor that is not on a CUDA device.
- :func:`pallas_conv` and :func:`csub_conv`: the tool's two entry points.
  On a CUDA tensor both launch the kernel, on a CPU tensor both take the
  plain version; ``csub_conv`` refuses a stride other than 1.
- :func:`xla_conv`: the library conv, ``F.conv3d`` on ``channels_last_3d``
  tensors, cropped to T3's extents.

Modes, each on the card only (exit 1 without one):

- ``check``: both dtypes, the JAX tool's ``CASES`` at its small sizes and a
  few cases more (odd extents under a stride, odd channel counts, more than
  one tile of output channels): ``pallas_conv`` against the plain version
  and the library conv. f32 within ``1e-4 * max(1, |y|max)``, bf16 within
  one rounding of the output (2^-7 of the value + 1e-3).
- ``check3``: the same for ``csub_conv`` at the JAX tool's two cases.
- ``bench``: ``pallas_conv`` at ``CASES`` in bf16 beside the library conv
  and the plain version, by CUDA events.
- ``bench3``: ``csub_conv`` at the JAX tool's ``bench3`` cases.

Every line of times carries the card's name and power limit. Not carried
over: the JAX tool's ``banded_conv``, ``decomposed3d_conv`` and ``bench2``,
pure-XLA reformulations that reach no Pallas kernel (TPU layout
experiments).
"""

from __future__ import annotations

import itertools
import math
import sys
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from nextou_tpu_torch.kernels.build import check_tensors, library, ptr
from nextou_tpu_torch.tools.timing import card, cuda_ms, require_card

_DTYPES = (torch.bfloat16, torch.float32)

# name, (N, D, H, W, C), Co, kernel, stride: the JAX tool's CASES
CASES = [
    ("e0b", (128, 1, 224, 192, 33), 33, (1, 3, 3), (1, 1, 1)),
    ("e1a", (2, 64, 224, 192, 33), 66, (3, 3, 3), (1, 2, 2)),
    ("e1b", (2, 64, 112, 96, 66), 66, (3, 3, 3), (1, 1, 1)),
    ("e2a", (2, 64, 112, 96, 66), 132, (3, 3, 3), (2, 2, 2)),
    ("e2b", (2, 32, 56, 48, 132), 132, (3, 3, 3), (1, 1, 1)),
    ("d4", (2, 8, 14, 12, 648), 324, (3, 3, 3), (1, 1, 1)),
    ("d0", (128, 1, 224, 192, 66), 33, (1, 3, 3), (1, 1, 1)),
]
# the JAX tool's bench3 cases (stride 1): name, (N, D, H, W, C), Co, kernel
BENCH3_CASES = [
    ("e1b", (2, 64, 112, 96, 66), 66, (3, 3, 3)),
    ("e2b", (2, 32, 56, 48, 132), 132, (3, 3, 3)),
    ("d1", (2, 64, 112, 96, 132), 66, (3, 3, 3)),
    ("d2", (2, 32, 56, 48, 264), 132, (3, 3, 3)),
    ("d3", (2, 16, 28, 24, 528), 264, (3, 3, 3)),
    ("e0b", (128, 1, 224, 192, 33), 33, (1, 3, 3)),
]
# check's cases beyond the JAX tool's: odd extents under a stride, odd and
# ragged channel counts, more than one tile of output rows, columns and
# channels, a (3, 1, 3) kernel
EXTRA_CHECK_CASES = [
    ("odd-s2", (1, 9, 19, 45, 7), 10, (3, 3, 3), (2, 2, 2)),
    ("odd-s122", (2, 5, 21, 67, 33), 75, (3, 3, 3), (1, 2, 2)),
    ("ragged", (1, 5, 19, 70, 35), 150, (3, 3, 3), (1, 1, 1)),
    ("k313", (1, 6, 10, 40, 6), 5, (3, 1, 3), (2, 1, 2)),
]


def _geometry(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int]):
    """``(kernel, stride, pads, out_spatial)``, or ``ValueError`` for what
    T3 does not compute."""
    if x.dim() != 5 or w.dim() != 5 or x.shape[-1] != w.shape[3]:
        raise ValueError(f"conv_cl: x {tuple(x.shape)} and w {tuple(w.shape)} do not fit "
                         "(N, D, H, W, C) and (kd, kh, kw, C, Co)")
    kernel, stride = tuple(w.shape[:3]), tuple(int(s) for s in stride)
    if len(stride) != 3 or any(k not in (1, 3) for k in kernel) or any(s not in (1, 2) for s in stride):
        raise ValueError(f"conv_cl: kernel {kernel} / stride {stride}; takes kernel dims "
                         "in {1, 3} and strides in {1, 2}")
    out = tuple(n // s for n, s in zip(x.shape[1:4], stride))
    if min(out) < 1:
        raise ValueError(f"conv_cl: input {tuple(x.shape[1:4])} under stride {stride} is empty")
    return kernel, stride, tuple((k - 1) // 2 for k in kernel), out


def conv_cl_reference(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int]) -> torch.Tensor:
    """Plain version of T3: for each tap ``(a, b, c)`` the slice of the
    zero-padded input at ``s * o + tap`` times ``w[a, b, c]`` (C, Co), summed
    in f32 and cast to ``x.dtype``; ``(N, D // sd, H // sh, W // sw, Co)``."""
    kernel, (sd, sh, sw), (pd, ph, pw), (Do, Ho, Wo) = _geometry(x, w, stride)
    xp = F.pad(x.float(), (0, 0, pw, pw, ph, ph, pd, pd))
    wf = w.float()
    acc = torch.zeros((x.shape[0], Do, Ho, Wo, w.shape[-1]), dtype=torch.float32, device=x.device)
    for a, b, c in itertools.product(*(range(k) for k in kernel)):
        tap = xp[:, a: a + (Do - 1) * sd + 1: sd, b: b + (Ho - 1) * sh + 1: sh,
                 c: c + (Wo - 1) * sw + 1: sw]
        acc += tap @ wf[a, b, c]
    return acc.to(x.dtype)


def conv_cl_cuda(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int]) -> torch.Tensor:
    """Launch T3's kernel on ``x (N, D, H, W, C)`` and ``w (kd, kh, kw, C,
    Co)``, both bf16 or both f32, contiguous, on one CUDA device. Returns
    ``(N, D // sd, H // sh, W // sw, Co)`` in ``x.dtype``.

    ``conv_cl_cuda.launches`` counts the launches.
    """
    kernel, stride, _, out_spatial = _geometry(x, w, stride)
    N, C, Co = x.shape[0], x.shape[-1], w.shape[-1]
    dev = check_tensors(
        "conv_cl_cuda", {"x": x, "w": w}, {"x": _DTYPES, "w": (x.dtype,)},
        {"x": x.shape, "w": (*kernel, C, Co)},
    )
    out = torch.empty((N, *out_spatial, Co), dtype=x.dtype, device=dev)
    lib = library("conv_cl")
    bf16 = int(x.dtype == torch.bfloat16)
    scratch_bytes = lib.conv_cl_scratch_bytes(C, Co, *kernel, bf16)
    if scratch_bytes < 0:
        raise ValueError(f"conv_cl_cuda: weights {tuple(w.shape)} are too large")
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev) if scratch_bytes else None
    with torch.cuda.device(dev):
        rc = lib.conv_cl_forward(
            ptr(x), ptr(w), ptr(out), ptr(scratch), N, *x.shape[1:4], C, Co, *kernel, *stride,
            bf16, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv_cl_cuda: launch failed with CUDA error {rc}")
    conv_cl_cuda.launches += 1
    return out


conv_cl_cuda.launches = 0


def pallas_conv(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int]) -> torch.Tensor:
    """T3's conv at any stride in {1, 2}: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.device.type == "cuda":
        return conv_cl_cuda(x.contiguous(), w.contiguous(), stride)
    if x.device.type != "cpu":
        raise NotImplementedError(f"pallas_conv on {x.device.type}")
    return conv_cl_reference(x, w, stride)


def csub_conv(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int] = (1, 1, 1)) -> torch.Tensor:
    """The same conv at stride 1, which is all the JAX tool's ``csub_conv``
    computes; another stride raises."""
    if tuple(stride) != (1, 1, 1):
        raise ValueError(f"csub_conv computes stride (1, 1, 1) only; got {tuple(stride)}")
    return pallas_conv(x, w, stride)


def xla_conv(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int]) -> torch.Tensor:
    """The library conv: ``F.conv3d`` on ``channels_last_3d`` tensors,
    cropped to T3's extents; ``(N, Do, Ho, Wo, Co)``."""
    xc, wc = library_operands(x, w)
    _, _, _, (Do, Ho, Wo) = _geometry(x, w, stride)
    y = library_conv(xc, wc, stride)[:, :, :Do, :Ho, :Wo]
    return y.permute(0, 2, 3, 4, 1)


def library_operands(x: torch.Tensor, w: torch.Tensor):
    """``x`` and ``w`` as ``F.conv3d`` takes them, in ``channels_last_3d``
    memory: ``x`` is that already (a view), ``w`` is copied once."""
    return (x.permute(0, 4, 1, 2, 3),
            w.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d))


def library_conv(xc: torch.Tensor, wc: torch.Tensor, stride: Sequence[int]) -> torch.Tensor:
    return F.conv3d(xc, wc, None, tuple(stride), [(k - 1) // 2 for k in wc.shape[2:]])


def seeded_case(shape, co, kernel, dtype, dev, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((*kernel, shape[-1], co)) * scale).astype(np.float32))
    return x.to(dev, dtype), w.to(dev, dtype)


def _check(entry, cases, dev) -> None:
    for dtype in (torch.float32, torch.bfloat16):
        for i, (name, shape, co, kernel, stride) in enumerate(cases):
            x, w = seeded_case(shape, co, kernel, dtype, dev, seed=i)
            got = entry(x, w, stride)
            torch.cuda.synchronize()
            for ref, want in (("plain", conv_cl_reference(x, w, stride)),
                              ("library", xla_conv(x, w, stride))):
                ok, err, scale = within_tolerance(got, want)
                print(f"{'OK' if ok else 'FAIL'} {entry.__name__} {str(dtype)[6:]} vs {ref} {name} "
                      f"{shape}->{co} k{kernel} s{stride}: max|err| {err:.2e} (|y| {scale:.2f})",
                      flush=True)
                if not ok:
                    raise AssertionError(f"{entry.__name__} disagrees with the {ref} conv at {name}")


def within_tolerance(got: torch.Tensor, want: torch.Tensor) -> tuple[bool, float, float]:
    """``(ok, max |err|, max |want|)``: f32 within ``1e-4 * max(1, |want|max)``
    (the sums differ in their order), bf16 within one rounding of the output,
    ``2^-7 |want| + 1e-3`` (every version sums in f32 and rounds once)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{tuple(got.shape)} {got.dtype} against {tuple(want.shape)} {want.dtype}")
    g, v = got.float(), want.float()
    diff = (g - v).abs()
    err, scale = diff.max().item(), v.abs().max().item()
    if got.dtype == torch.float32:
        ok = err <= 1e-4 * max(1.0, scale)
    else:
        ok = bool((diff <= 2.0 ** -7 * v.abs() + 1e-3).all())
    return ok and bool(torch.isfinite(g).all()), err, scale


def small_cases():
    """The JAX tool's ``check`` sizes: each case at ``(2, 8 or 1, 16, 12, C)``."""
    return [(name, (2, 8 if shape[1] > 1 else 1, 16, 12, shape[4]), co, k, s)
            for name, shape, co, k, s in CASES]


def check3_cases():
    """The JAX tool's ``check3``: ``(2, 8, 16, 12, 5)`` to 4 channels, stride 1."""
    return [(f"csub{k}", (2, 8, 16, 12, 5), 4, k, (1, 1, 1)) for k in ((3, 3, 3), (1, 3, 3))]


def check(dev) -> None:
    _check(pallas_conv, small_cases() + EXTRA_CHECK_CASES, dev)


def check3(dev) -> None:
    _check(csub_conv, check3_cases(), dev)


def time_case(entry, shape, co, kernel, stride, dev, seed=0) -> dict:
    """One case in bf16 at full size: the kernel through ``entry``, the
    library conv and the plain version (ms by CUDA events), the largest
    difference from the plain version, and the operations and bytes."""
    x, w = seeded_case(shape, co, kernel, torch.bfloat16, dev, seed, scale=0.05)
    got = entry(x, w, stride)
    want = conv_cl_reference(x, w, stride)
    ok, err, _ = within_tolerance(got, want)
    if not ok:
        raise AssertionError(f"{entry.__name__} disagrees with the plain version at {shape}")
    del want
    xc, wc = library_operands(x, w)
    out = {
        "ms": cuda_ms(lambda: entry(x, w, stride)),
        "library_ms": cuda_ms(lambda: library_conv(xc, wc, stride)),
        "plain_ms": cuda_ms(lambda: conv_cl_reference(x, w, stride), iters=2, warmup=1),
        "max_abs_err": err,
        "flops": 2.0 * got.shape[0] * math.prod(got.shape[1:4]) * math.prod(kernel) * shape[-1] * co,
        "bytes": (x.numel() + w.numel() + got.numel()) * 2,
    }
    del x, w, got, xc, wc
    torch.cuda.empty_cache()
    return out


def bench(dev, three: bool) -> None:
    name_line = card()
    entry = csub_conv if three else pallas_conv
    cases = [(n, s, co, k, (1, 1, 1)) for n, s, co, k in BENCH3_CASES] if three else CASES
    for name, shape, co, kernel, stride in cases:
        r = time_case(entry, shape, co, kernel, stride, dev)
        print(f"{name} {shape}->{co} k{kernel} s{stride} bf16: {entry.__name__} {r['ms']:8.3f} ms "
              f"({r['flops'] / r['ms'] / 1e9:6.1f} TFLOP/s) | F.conv3d channels_last "
              f"{r['library_ms']:8.3f} ms | plain {r['plain_ms']:8.3f} ms | {name_line}", flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "check"
    if mode not in ("check", "bench", "check3", "bench3"):
        print(__doc__, file=sys.stderr)
        return 2
    if not require_card("exp_conv_kernel"):
        return 1
    # the library conv and the plain version are the yardstick in full f32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card())
    if mode in ("check", "check3"):
        (check if mode == "check" else check3)(dev)
        print("ALL CASES PASS")
    else:
        bench(dev, three=mode == "bench3")
    return 0


if __name__ == "__main__":
    sys.exit(main())
