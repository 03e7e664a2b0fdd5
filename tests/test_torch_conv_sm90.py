"""The plan and the K order of the bf16 wgmma conv core (``csrc/conv_sm90.cuh``)
that K5 (``kernels/conv.py``) and T3 (``tools/exp_conv_kernel.py``) share,
on the CPU: pure torch and numpy (the JAX side of both convs is held by
``test_torch_conv.py`` and ``test_torch_conv_cl.py``).

- The plan (:func:`conv_sm90_plan`, the mirror of the library's) fits a
  ring of at least two stages in a block's 232,448 bytes of shared memory,
  its N tiles cover Co, its M blocks cover every output position once and
  its chunks every (tap, channel) once, at every flagship conv, every shape
  of T3's tool, every check case and shapes that need a smaller block; it
  is total over a seeded sweep of shapes, and the smoke run's narrow convs
  keep one tap per k16 step.
- The kernel's sum, emulated: A gathered from the padded input in the plan's
  order (block, position, chunk, granule slot), B unpacked from the Python
  mirror of the weight packing (which the card test holds bit-equal to the
  kernel's), one f32 matmul over the padded K: equal to the plain versions
  within 1e-5. The inputs are multiples of 1/4 and 1/8 in [-1, 1], so that
  every product and every sum (at most 27 x 72 terms) is exact in f32 and
  the two orders of the sum give the same bits: what the check sees is the
  K order alone.
"""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nextou_tpu_torch.kernels.conv import (
    PLAN_KEYS,
    SM90_SMEM_LIMIT,
    conv3d_reference,
    conv_sm90_plan,
    pack_weights_sm90,
)
from nextou_tpu_torch.tools import exp_conv_kernel as t3
from nextou_tpu_torch.tools.exp_conv_v2 import CHECK_CASES, FLAGSHIP_SHAPES

# the five convs of K5's region in a flagship-geometry network at widths 6 / 12:
# (name, C, Co, stride, input spatial)
NARROW_CONVS = [
    ("e1a", 6, 12, (1, 2, 2), (64, 224, 192)), ("e1b", 12, 12, (1, 1, 1), (64, 112, 96)),
    ("e2a", 12, 12, (2, 2, 2), (64, 112, 96)), ("d1a", 24, 12, (1, 1, 1), (64, 112, 96)),
    ("d1b", 12, 12, (1, 1, 1), (64, 112, 96)),
]

# the convs K5 takes in the planner's 3d_lowres PlainConvUNet (96 x 160 x 160,
# widths 32 / 64; e0a on the one input channel) and in the 3d_fullres
# ResidualEncoderUNet (its stage-1 conv1), as the smoke run's phase 18 runs them
LOWRES_CONVS = [
    ("e0a", 1, 32, (1, 1, 1), (96, 160, 160)), ("e0b", 32, 32, (1, 1, 1), (96, 160, 160)),
    ("e1a", 32, 64, (2, 2, 2), (96, 160, 160)), ("d0a", 64, 32, (1, 1, 1), (96, 160, 160)),
    ("d0b", 32, 32, (1, 1, 1), (96, 160, 160)), ("r1", 32, 64, (1, 2, 2), (56, 192, 160)),
]

# (layout, B, C, (D, H, W), Co, kernel, stride)
PLAN_SHAPES = (
    [("ncdhw", B, C, sp, Co, (3, 3, 3), st) for B in (1, 4) for _, sp, C, Co, st in FLAGSHIP_SHAPES]
    + [("ncdhw", B, C, sp, Co, k, st) for B, sp, C, Co, k, st in CHECK_CASES]
    + [("ndhwc", s[0], s[4], s[1:4], co, k, st)
       for _, s, co, k, st in t3.CASES + t3.small_cases() + t3.EXTRA_CHECK_CASES + t3.check3_cases()]
    + [("ndhwc", s[0], s[4], s[1:4], co, k, (1, 1, 1)) for _, s, co, k in t3.BENCH3_CASES]
    # where a ring of two stages needs a smaller block or chunks of 8 at C <= 32:
    # nnU-Net's first downsample 32 -> 64, a narrow C with a wide N, N = 168 at
    # column stride 2
    + [(layout, 1, C, sp, Co, (3, 3, 3), st) for layout in ("ncdhw", "ndhwc")
       for C, sp, Co, st in ((32, (128, 128, 128), 64, (2, 2, 2)),
                             (32, (128, 128, 128), 64, (1, 2, 2)),
                             (24, (16, 64, 64), 132, (1, 1, 1)),
                             (66, (16, 64, 192), 168, (2, 2, 2)))]
    # the narrow network of the smoke run's phase 10 (the flagship's geometry at
    # widths 6 / 12), which must keep one tap per k16 step
    + [("ncdhw", 2, C, sp, Co, (3, 3, 3), st) for _, C, Co, st, sp in NARROW_CONVS]
    + [("ncdhw", B, C, sp, Co, (3, 3, 3), st) for B in (1, 2, 4)
       for _, C, Co, st, sp in LOWRES_CONVS]
)


def _slots(plan: dict, taps: int, C: int):
    """The K order: per chunk and granule slot ``(tap, first channel)``, or
    ``None`` for a slot that carries no weight."""
    cs, chunks = plan["cs"], plan["chunks"]
    out = []
    for k in range(chunks):
        last = k == chunks - 1
        gpc = plan["gpc_last"] if last else cs // 8
        for q in range(plan["q2_last"] if last else plan["q2_full"]):
            tap, c = q // gpc, k * cs + (q % gpc) * 8
            out.append((tap, c) if tap < taps else None)
    return out


def _blocks(plan: dict, B: int):
    """Each block's ``(b, od, oh0, ow0, n tile)``, in the kernel's order."""
    Do = plan["out"][0]
    for i in range(plan["ctas"]):
        nt, i = i % plan["n_tiles"], i // plan["n_tiles"]
        ow, i = i % plan["n_wt"], i // plan["n_wt"]
        oh, i = i % plan["n_ht"], i // plan["n_ht"]
        yield i // Do, i % Do, oh * plan["th"], ow * plan["tw"], nt


@pytest.mark.parametrize("layout,B,C,spatial,Co,kernel,stride", PLAN_SHAPES)
def test_plan_fits_and_covers_once(layout, B, C, spatial, Co, kernel, stride):
    plan = conv_sm90_plan(layout, B, C, spatial, Co, kernel, stride)
    assert set(PLAN_KEYS) <= set(plan)
    assert plan["smem"] <= SM90_SMEM_LIMIT and plan["stages"] >= 2 and plan["splits"] == 1
    n, nt = plan["n"], plan["n_tiles"]
    assert n % 8 == 0 and n * nt >= Co > n * (nt - 1)
    assert plan["th"] * plan["tw"] <= 128
    assert plan["route"] == ((3 if spatial[2] % 8 == 0 else 0) if layout == "ncdhw"
                             else 0 if C % 2 else 1 if C % 8 == 0 else 2)
    # every output position and channel once
    Do, Ho, Wo = plan["out"]
    hits = np.zeros((B, Do, Ho, Wo, nt), np.int64)
    for b, od, oh0, ow0, t in _blocks(plan, B):
        hits[b, od, oh0: oh0 + plan["th"], ow0: ow0 + plan["tw"], t] += 1
    assert (hits == 1).all()
    # every (tap, channel) once; K pads C to a multiple of 8, not 16, but for
    # C <= 32 in chunks of 16 or 32 channels: every k16 step then one tap's
    taps = int(np.prod(kernel))
    c_pad = -(-C // 16) * 16 if C <= 32 and plan["cs"] >= 16 else -(-C // 8) * 8
    slots = _slots(plan, taps, C)
    seen = np.zeros((taps, c_pad), np.int64)
    for slot in slots:
        if slot is not None:
            seen[slot[0], slot[1]: slot[1] + 8] += 1
    assert (seen == 1).all()
    assert plan["granules"] == taps * c_pad // 8
    if C <= 32 and plan["cs"] >= 16:
        assert all(a is None or b is None or a[0] == b[0] for a, b in zip(slots[::2], slots[1::2]))
    assert plan["k_steps"] * 2 == len(slots) < plan["granules"] + 2 * plan["chunks"]


@pytest.mark.parametrize("name,C,Co,stride,spatial",
                         NARROW_CONVS + [c for c in LOWRES_CONVS if c[1] <= 16])
def test_narrow_convs_take_one_chunk_of_one_tap_steps(name, C, Co, stride, spatial):
    """At C <= 32 the plan takes one chunk of 16 channels a tap where its ring
    has two stages: the k order of the library conv, which the smoke run's
    narrow network holds to argmax agreement with cuDNN."""
    plan = conv_sm90_plan("ncdhw", 2, C, spatial, Co, (3, 3, 3), stride)
    assert plan["chunks"] == 1 and plan["cs"] == -(-C // 16) * 16 and plan["stages"] >= 2


@pytest.mark.parametrize("seed", range(4))
def test_plan_is_total(seed):
    """Every shape of kernel dims {1, 3} and strides {1, 2} has a plan with a
    ring of at least two stages in a block's shared memory."""
    rng = np.random.default_rng(seed)
    for _ in range(500):
        C = int(rng.integers(1, 40) if rng.random() < 0.5 else rng.integers(1, 700))
        kernel, stride = tuple(rng.choice((1, 3), 3)), tuple(rng.choice((1, 2), 3))
        for layout in ("ncdhw", "ndhwc"):
            plan = conv_sm90_plan(layout, 1, C, tuple(rng.integers(2, 200, 3)),
                                  int(rng.integers(1, 400)), kernel, stride)
            assert plan["stages"] >= 2 and plan["smem"] <= SM90_SMEM_LIMIT
            assert plan["th"] * plan["tw"] <= 128


def _emulate(layout: str, xc: torch.Tensor, wt: torch.Tensor, kernel, stride) -> torch.Tensor:
    """The kernel's sum for NCDHW ``xc`` and ``wt (taps, C, Co)``: ``(B, Co,
    Do, Ho, Wo)`` f32, block by block, each position and N tile written
    once."""
    B, C = xc.shape[:2]
    taps, _, Co = wt.shape
    plan = conv_sm90_plan(layout, B, C, tuple(xc.shape[2:]), Co, kernel, stride)
    (Do, Ho, Wo), (sd, sh, sw) = plan["out"], stride
    pads = [(k - 1) // 2 for k in kernel]
    xp = F.pad(xc.float(), (pads[2], pads[2], pads[1], pads[1], pads[0], pads[0]))
    xp = F.pad(xp, (0, 0, 0, 0, 0, 0, 0, plan["chunks"] * plan["cs"] - C))  # channels past C: 0
    tap_of = list(itertools.product(*(range(k) for k in kernel)))
    cols = []  # A: (B, Do, Ho, Wo) per K index, in the plan's order
    for slot in _slots(plan, taps, C):
        for e in range(8):
            if slot is None:
                cols.append(torch.zeros(B, Do, Ho, Wo))
                continue
            (a, b, c), ch = tap_of[slot[0]], slot[1] + e
            cols.append(xp[:, ch, a: a + (Do - 1) * sd + 1: sd, b: b + (Ho - 1) * sh + 1: sh,
                           c: c + (Wo - 1) * sw + 1: sw])
    A = torch.stack(cols, -1)  # (B, Do, Ho, Wo, K)
    packed = pack_weights_sm90(wt.float(), plan)  # (n_tiles, slots, n, 8)
    Bm = packed.permute(0, 1, 3, 2).reshape(plan["n_tiles"], -1, plan["n"])  # (tiles, K, n)
    out = torch.full((B, plan["n_tiles"] * plan["n"], Do, Ho, Wo), float("nan"))
    for b, od, oh0, ow0, t in _blocks(plan, B):
        rows = A[b, od, oh0: oh0 + plan["th"], ow0: ow0 + plan["tw"]]
        y = rows.reshape(-1, A.shape[-1]) @ Bm[t]
        co = slice(t * plan["n"], (t + 1) * plan["n"])
        out[b, co, od, oh0: oh0 + plan["th"], ow0: ow0 + plan["tw"]] = (
            y.reshape(*rows.shape[:2], -1).permute(2, 0, 1))
    assert not out[:, :Co].isnan().any()
    assert (out[:, Co:] == 0).all()  # the padded output channels carry zero weights
    return out[:, :Co]


# (B, C, (D, H, W), Co, kernel, stride): C = 33, Co = 33 and 324, both
# strides, odd extents, Wo = 12, a shrunk block, chunks of 8 at C <= 32
EMULATION_CASES = [
    (1, 33, (3, 9, 24), 33, (3, 3, 3), (1, 2, 2)),
    (2, 33, (5, 7, 23), 324, (3, 3, 3), (2, 2, 2)),
    (1, 66, (4, 13, 12), 33, (3, 3, 3), (1, 1, 1)),
    (1, 33, (1, 11, 37), 33, (1, 3, 3), (1, 1, 1)),
    (1, 20, (3, 6, 12), 324, (3, 1, 3), (2, 1, 2)),
    (1, 40, (3, 6, 64), 168, (3, 3, 3), (2, 2, 2)),  # a block of 2 rows, not 4
    (1, 24, (3, 5, 40), 132, (3, 3, 3), (1, 1, 1)),  # C <= 32, chunks of 8
    (2, 1, (4, 6, 40), 32, (3, 3, 3), (1, 1, 1)),  # one input channel, padded to 16
    (1, 1, (4, 7, 34), 32, (3, 3, 3), (2, 2, 2)),
]


@pytest.mark.parametrize("B,C,spatial,Co,kernel,stride", EMULATION_CASES)
def test_emulated_k_order_matches_the_plain_versions(B, C, spatial, Co, kernel, stride):
    rng = np.random.default_rng(C + Co + sum(spatial))
    x = torch.from_numpy((rng.integers(-4, 5, (B, C, *spatial)) / 4).astype(np.float32))
    w = torch.from_numpy((rng.integers(-8, 9, (Co, C, *kernel)) / 8).astype(np.float32))
    taps = int(np.prod(kernel))
    # K5: NCDHW, w (Co, C, kd, kh, kw)
    got = _emulate("ncdhw", x, w.reshape(Co, C, taps).permute(2, 1, 0), kernel, stride)
    torch.testing.assert_close(got, conv3d_reference(x, w, stride), rtol=0, atol=1e-5)
    # T3: NDHWC, w (kd, kh, kw, C, Co), output extents n // s
    xl, wl = x.permute(0, 2, 3, 4, 1).contiguous(), w.permute(2, 3, 4, 1, 0).contiguous()
    got = _emulate("ndhwc", x, wl.reshape(taps, C, Co), kernel, stride)
    torch.testing.assert_close(got.permute(0, 2, 3, 4, 1), t3.conv_cl_reference(xl, wl, stride),
                               rtol=0, atol=1e-5)
