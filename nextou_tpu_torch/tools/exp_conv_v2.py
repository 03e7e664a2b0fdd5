"""Check and time the conv kernel K5 on a CUDA card.

    python -m nextou_tpu_torch.tools.exp_conv_v2 {check,bench,benchwrap}

Counterpart of the JAX package's ``tools/exp_conv_v2.py``, whose prototype
kernel became ``kernels/conv.py``; here the tool drives the kernel itself.

- ``check``: K5 against its plain version and against ``F.conv3d`` (TF32
  off), in f32 and in bf16, at small cases: every kernel and stride
  pattern, odd channel counts, ragged tiles. Fails on the first case
  outside its tolerance.
- ``bench``: K5 and ``F.conv3d`` by CUDA events at the five flagship shapes
  the network hands to the kernel, bf16, batch 2 and 4, each beside the bf16
  kernel's plan (``kernels.conv.conv_sm90_plan``).
- ``benchwrap``: the same inside ``ConvNormAct`` (conv, bias, BatchNorm in
  eval mode, LeakyReLU), which is what the network swaps.

Every line of times carries the card's name and power limit.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from nextou_tpu_torch.kernels.conv import conv3d_cuda, conv3d_reference, describe_plan, library_plan
from nextou_tpu_torch.tools.timing import card, cuda_ms, require_card

# B, (D, H, W), C, Co, kernel, stride
CHECK_CASES = [
    (1, (4, 16, 120), 5, 7, (3, 3, 3), (1, 1, 1)),
    (2, (3, 8, 126), 33, 33, (1, 3, 3), (1, 1, 1)),
    (1, (5, 16, 96), 12, 9, (3, 3, 3), (1, 1, 1)),
    (1, (4, 32, 64), 9, 8, (3, 3, 3), (1, 2, 2)),
    (1, (8, 16, 32), 7, 10, (3, 3, 3), (2, 2, 2)),
    # more than one tile of output channels and of input-channel chunks,
    # ragged rows and columns, odd extents under a stride
    (2, (5, 19, 45), 35, 75, (3, 3, 3), (1, 1, 1)),
    (1, (7, 21, 71), 19, 11, (3, 3, 3), (2, 2, 2)),
    (1, (6, 10, 40), 6, 5, (3, 1, 3), (2, 1, 2)),
]
# name, input (D, H, W), C, Co, stride: the (3, 3, 3) convs of the flagship
# that lie in the kernel's region
FLAGSHIP_SHAPES = [
    ("e1a", (64, 224, 192), 33, 66, (1, 2, 2)),
    ("e1b", (64, 112, 96), 66, 66, (1, 1, 1)),
    ("e2a", (64, 112, 96), 66, 132, (2, 2, 2)),
    ("d1a", (64, 112, 96), 132, 66, (1, 1, 1)),
    ("d1b", (64, 112, 96), 66, 66, (1, 1, 1)),
]


def seeded_case(B, spatial, C, Co, kernel, dtype, dev, seed=0, w_scale=0.1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(B, C, *spatial, generator=gen, device=dev).to(dtype)
    w = (torch.randn(Co, C, *kernel, generator=gen, device=dev) * w_scale).to(dtype)
    return x, w


def library_conv(x, w, stride):
    return F.conv3d(x, w, None, stride, [(k - 1) // 2 for k in w.shape[2:]])


def check(dev) -> None:
    """K5 against its plain version and the library conv. In f32 (the FMA
    kernel) within 1e-3 of the largest output (at least 1e-3), the tolerance
    of the JAX tool: the sums differ only in their order. In bf16 (the
    tensor-core kernel) every value within one rounding of the output, 2^-7
    of the value + 1e-3: all three sum in f32 and round once."""
    for dtype in (torch.float32, torch.bfloat16):
        for B, spatial, C, Co, kernel, stride in CHECK_CASES:
            x, w = seeded_case(B, spatial, C, Co, kernel, dtype, dev)
            got = conv3d_cuda(x, w, stride).float()
            torch.cuda.synchronize()
            for name, want in (("plain", conv3d_reference(x, w, stride)),
                               ("library", library_conv(x, w, stride))):
                want = want.float()
                assert got.shape == want.shape, (got.shape, want.shape)
                diff = (got - want).abs()
                scale = want.abs().max().item()
                if dtype == torch.float32:
                    ok = diff.max().item() < 1e-3 * max(scale, 1.0)
                else:
                    ok = bool((diff <= 2.0 ** -7 * want.abs() + 1e-3).all())
                print(f"{'OK' if ok else 'FAIL'} {str(dtype)[6:]} vs {name} B{B} {spatial} C{C}->{Co} "
                      f"k{kernel} s{stride}: max|err| {diff.max().item():.2e} (|y| {scale:.1f})",
                      flush=True)
                if not ok:
                    raise AssertionError(f"K5 disagrees with the {name} conv at {spatial}")


def bench(dev, wrap: bool) -> None:
    from nextou_tpu_torch.nn.conv_blocks import ConvNormAct

    name_line = card()
    for B in (2, 4):
        for name, spatial, C, Co, stride in FLAGSHIP_SHAPES:
            x, w = seeded_case(B, spatial, C, Co, (3, 3, 3), torch.bfloat16, dev, w_scale=0.05)
            out = [(n + 2 - 3) // s + 1 for n, s in zip(spatial, stride)]
            flops = 2.0 * B * out[0] * out[1] * out[2] * 27 * C * Co
            if wrap:
                blocks = {
                    mode: ConvNormAct(C, Co, (3, 3, 3), stride, conv_kernel=mode, device=dev).eval()
                    for mode in ("1", "0")
                }
                blocks["0"].load_state_dict(blocks["1"].state_dict())
                with torch.inference_mode():
                    t_k5 = cuda_ms(lambda: blocks["1"](x))
                    t_lib = cuda_ms(lambda: blocks["0"](x))
            else:
                t_k5 = cuda_ms(lambda: conv3d_cuda(x, w, stride))
                t_lib = cuda_ms(lambda: library_conv(x, w, stride))
            plan = describe_plan(library_plan("conv3d", (B, C, *spatial, Co, 3, 3, 3, *stride)))
            print(f"{name} batch {B} bf16{' in ConvNormAct' if wrap else ''}: "
                  f"K5 {t_k5:8.3f} ms ({flops / t_k5 / 1e9:6.1f} TFLOP/s) | library "
                  f"{t_lib:8.3f} ms ({flops / t_lib / 1e9:6.1f} TFLOP/s) | {plan} | {name_line}",
                  flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "check"
    if mode not in ("check", "bench", "benchwrap"):
        print(__doc__, file=sys.stderr)
        return 2
    if not require_card("exp_conv_v2"):
        return 1
    # the library conv is the yardstick in full f32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(card())
    if mode == "check":
        check(dev)
        print("ALL CASES PASS")
    else:
        bench(dev, wrap=mode == "benchwrap")
    return 0


if __name__ == "__main__":
    sys.exit(main())
