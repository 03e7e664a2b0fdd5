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

- K5 :func:`conv3d_cuda` (``csrc/conv3d.cu``): the kernel, on the tensor
  cores for bf16 and as f32 FMAs for f32; it reads and writes NCDHW
  directly, with no padded copy and no layout pass around it.
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

import itertools
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from nextou_tpu_torch.kernels.build import check_tensors, library, ptr

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


def conv3d_cuda(x: torch.Tensor, w: torch.Tensor, stride: Sequence[int]) -> torch.Tensor:
    """Launch K5 on ``x (B, C, D, H, W)`` and ``w (Co, C, kd, kh, kw)``, both
    bf16 or both f32, contiguous, on one CUDA device. Returns
    ``(B, Co, Do, Ho, Wo)`` in ``x.dtype``.

    ``conv3d_cuda.launches`` counts the launches.
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
    # the bf16 kernel reads the weights repacked; it repacks them itself
    scratch_bytes = lib.conv3d_scratch_bytes(C, Co, *kernel, bf16)
    if scratch_bytes < 0:
        raise ValueError(f"conv3d_cuda: weights {tuple(w.shape)} are too large")
    scratch = torch.empty(scratch_bytes, dtype=torch.uint8, device=dev) if scratch_bytes else None
    with torch.cuda.device(dev):
        rc = lib.conv3d_forward(
            ptr(x), ptr(w), ptr(out), ptr(scratch), B, C, *x.shape[2:], Co, *kernel, *stride,
            bf16, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv3d_cuda: launch failed with CUDA error {rc}")
    conv3d_cuda.launches += 1
    return out


conv3d_cuda.launches = 0


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
