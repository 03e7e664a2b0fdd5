"""The port's tap-list conv (``nextou_tpu_torch/kernels/conv.py``) against
``nextou_tpu.kernels.conv`` on the CPU.

The same inputs, made from a numpy seed, go through the JAX function and the
port's. The JAX kernel runs in Pallas interpret mode, as
``tests/test_conv_kernel.py`` runs it; on the CPU the port's dispatcher takes
the plain version, which repeats the CUDA kernel's arithmetic (a sum over
the real taps in f32). The JAX side is channels-last with ``(kd, kh, kw, C,
Co)`` weights, the port channels-first with a ``Conv3d`` module's own
``(Co, C, kd, kh, kw)``.
"""

import itertools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

from nextou_tpu.kernels.conv import _xla_conv, pallas_conv, pallas_conv_wins
from nextou_tpu_torch.kernels.conv import (
    Conv3dKernel,
    conv3d,
    conv3d_cuda,
    conv3d_reference,
    conv_kernel_wins,
)
from nextou_tpu_torch.losses import CompoundLossSpec, deep_supervision_weights
from nextou_tpu_torch.models import NexToU, presets
from nextou_tpu_torch.models.spec import build_model_spec
from nextou_tpu_torch.nn import conv_blocks
from nextou_tpu_torch.nn.conv_blocks import ConvNormAct
from nextou_tpu_torch.tools import exp_conv_probe
from nextou_tpu_torch.train import create_train_state, make_optimizer, make_train_step
from nextou_tpu_torch.utils import init_weights
from tests.test_conv_kernel import CASES


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case(B, sp, C, Co, ks, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, *sp, C)).astype(np.float32)
    w = (rng.standard_normal((*ks, C, Co)) * 0.1).astype(np.float32)
    return x, w


def _to_port(x, w):
    """Channels-last input and (kd, kh, kw, C, Co) weights -> the port's."""
    return (torch.from_numpy(np.moveaxis(x, -1, 1).copy()),
            torch.from_numpy(np.transpose(w, (4, 3, 0, 1, 2)).copy()))


def _library_conv(x, w, stride):
    return F.conv3d(x, w, None, stride, [(k - 1) // 2 for k in w.shape[2:]])


@pytest.mark.parametrize("B,sp,C,Co,ks,st_,nc", CASES)
def test_plain_conv_matches_pallas_and_xla(B, sp, C, Co, ks, st_, nc):
    """All three assembly modes of the JAX kernel are the one port function.
    atol 1e-3 as in tests/test_conv_kernel.py; against the library conv 1e-4
    (f32 sums of at most 27 * 33 terms in another order)."""
    x, w = _case(B, sp, C, Co, ks)
    xt, wt = _to_port(x, w)
    got = conv3d_reference(xt, wt, st_)
    assert got.dtype == torch.float32
    got_cl = got.movedim(1, -1).numpy()
    pallas = np.asarray(pallas_conv(jnp.asarray(x), jnp.asarray(w), st_, nc, True))
    xla = np.asarray(_xla_conv(jnp.asarray(x), jnp.asarray(w), st_))
    assert got_cl.shape == pallas.shape == xla.shape
    np.testing.assert_allclose(got_cl, pallas, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got_cl, xla, rtol=0, atol=1e-3)
    torch.testing.assert_close(got, _library_conv(xt, wt, st_), rtol=0, atol=1e-4)
    # the dispatcher on a CPU tensor is the plain version, and launches nothing
    before = conv3d_cuda.launches
    assert torch.equal(conv3d(xt, wt, st_), got) and conv3d_cuda.launches == before


_DIM = st.sampled_from([1, 3])
_STRIDE = st.sampled_from([1, 2])


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(kernel=st.tuples(_DIM, _DIM, _DIM), stride=st.tuples(_STRIDE, _STRIDE, _STRIDE),
       spatial=st.tuples(st.integers(1, 7), st.integers(1, 9), st.integers(1, 12)),
       c=st.sampled_from([1, 3, 5]), co=st.sampled_from([1, 3, 7]),
       seed=st.integers(0, 2 ** 16))
def test_plain_conv_matches_library_conv_everywhere(kernel, stride, spatial, c, co, seed):
    """Kernel dims in {1, 3}, strides in {1, 2}, odd channel counts, extents
    that the strides do not divide."""
    x, w = _case(2, spatial, c, co, kernel, seed)
    xt, wt = _to_port(x, w)
    got = conv3d_reference(xt, wt, stride)
    want = _library_conv(xt, wt, stride)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_plain_conv_rounds_once_and_refuses_what_the_kernel_does_not_take():
    x, w = _to_port(*_case(1, (4, 8, 16), 5, 6, (3, 3, 3)))
    got = conv3d_reference(x.bfloat16(), w.bfloat16(), (1, 2, 2))
    assert got.dtype == torch.bfloat16
    # bf16 in, an f32 sum, one rounding at the end
    want = _library_conv(x.bfloat16().float(), w.bfloat16().float(), (1, 2, 2)).bfloat16()
    assert (got.float() - want.float()).abs().max() <= 2 ** -7 * want.float().abs().max()
    for bad_w, bad_stride in ((w[:, :, :2], (1, 1, 1)), (w, (3, 1, 1)), (w, (1, 1)),
                              (w[:, :3], (1, 1, 1))):
        with pytest.raises(ValueError):
            conv3d_reference(x, bad_w, bad_stride)
    with pytest.raises(ValueError):  # a CUDA wrapper never takes a CPU tensor
        conv3d_cuda(x, w, (1, 1, 1))
    with pytest.raises(NotImplementedError):
        conv3d(x.to("meta"), w.to("meta"))


def test_conv_kernel_gradients_are_the_library_convs():
    """The case of tests/test_conv_kernel.py::test_pallas_conv_grads_are_xla_grads:
    bit-equal to F.conv3d's gradients for one cotangent, and within 1e-4 of
    jax.grad through pallas_conv."""
    stride = (1, 2, 2)
    x, w = _case(1, (4, 8, 64), 5, 6, (3, 3, 3), seed=1)
    xt, wt = (t.requires_grad_() for t in _to_port(x, w))
    y = Conv3dKernel.apply(xt, wt, stride)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(y.shape).astype(np.float32))
    got = torch.autograd.grad(y, (xt, wt), g)
    want = torch.autograd.grad(_library_conv(xt, wt, stride), (xt, wt), g)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    only_w = torch.autograd.grad(conv3d(xt.detach(), wt, stride), wt, g)[0]
    assert torch.equal(only_w, want[1])

    def loss_pallas(x, w):
        return jnp.sum(jnp.sin(pallas_conv(x, w, stride, 0, True)))

    jx, jw = jax.grad(loss_pallas, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    px, pw = torch.autograd.grad(torch.sin(conv3d(xt, wt, stride)).sum(), (xt, wt))
    np.testing.assert_allclose(px.movedim(1, -1).numpy(), np.asarray(jx), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pw.permute(2, 3, 4, 1, 0).numpy(), np.asarray(jw), rtol=0, atol=1e-4)


def test_conv_kernel_region_matches_jax():
    table = [  # tests/test_conv_kernel.py::test_dispatch_policy_flagship_table
        ((64, 192, 224), 33, 66, (3, 3, 3), (1, 2, 2), True),
        ((64, 96, 112), 66, 132, (3, 3, 3), (2, 2, 2), True),
        ((64, 96, 112), 132, 66, (3, 3, 3), (1, 1, 1), True),
        ((64, 96, 112), 66, 66, (3, 3, 3), (1, 1, 1), True),
        ((64, 192, 224), 33, 33, (1, 3, 3), (1, 1, 1), False),
        ((16, 24, 28), 264, 264, (3, 3, 3), (1, 1, 1), False),
        ((32, 48, 56), 264, 132, (3, 3, 3), (1, 1, 1), False),
        ((5, 7, 6), 324, 324, (3, 3, 3), (1, 1, 1), False),
    ]
    for sp, c, co, ks, st_, want in table:
        assert conv_kernel_wins(sp, c, co, ks, st_) is want
        assert pallas_conv_wins(sp, c, co, ks, st_) is want
    grid = itertools.product(
        [(64, 224, 192), (64, 112, 96), (64, 96, 112), (64, 96, 94), (63, 112, 96),
         (32, 56, 48), (64, 108, 100), (128, 48, 112), (64, 192, 47)],
        [(33, 66), (132, 66), (192, 192), (193, 66), (66, 264)],
        [(3, 3, 3), (1, 3, 3), (3, 3, 1)],
        [(1, 1, 1), (1, 2, 2), (2, 2, 2), (2, 1, 2)],
    )
    n = 0
    for sp, (c, co), ks, st_ in grid:
        assert conv_kernel_wins(sp, c, co, ks, st_) == pallas_conv_wins(sp, c, co, ks, st_)
        n += conv_kernel_wins(sp, c, co, ks, st_)
    assert 0 < n < 9 * 5 * 3 * 4


def _count_kernel_convs(monkeypatch):
    calls = []
    real = conv_blocks.conv3d

    def counted(x, w, stride=(1, 1, 1)):
        calls.append((x.shape[1], w.shape[0], tuple(stride), tuple(x.shape[2:])))
        return real(x, w, stride)

    monkeypatch.setattr(conv_blocks, "conv3d", counted)
    return calls


E1A = (1, 2, (1, 2, 2), (64, 224, 192))
E1B = (2, 2, (1, 1, 1), (64, 112, 96))
E2A = (2, 4, (2, 2, 2), (64, 112, 96))
D1A = (4, 2, (1, 1, 1), (64, 112, 96))
D1B = (2, 2, (1, 1, 1), (64, 112, 96))


@pytest.mark.parametrize("mode,want", [
    ("1", [E1A, E1B, E2A, D1A, D1B]), ("s1", [E1B, D1A, D1B]), ("s2", [E1A, E2A]), ("0", []),
])
def test_flagship_geometry_routes_the_listed_convs(mode, want, monkeypatch):
    """The flagship's patch, kernels and strides at an eleventh of its first
    three widths (features 3/6/12 for 33/66/132, 12 below: the region looks
    at widths only through its 192-channel cap, which the flagship's routed
    convs stay under). Channels are counted in units of the first stage's."""
    flagship = presets.flagship_3d_spec()
    spec = build_model_spec(
        in_channels=1, patch_size=flagship.patch_size, n_stages=6,
        features_per_stage=[3, 6, 12, 12, 12, 12],
        kernel_sizes=[s.kernel_size for s in flagship.encoder],
        strides=[s.stride for s in flagship.encoder],
        n_conv_per_stage=[2] * 6, n_conv_per_stage_decoder=[2] * 5,
        num_classes=2, deep_supervision=False,
    )
    for s, f in zip(spec.encoder, flagship.encoder):
        assert (s.kernel_size, s.stride, s.img_shape) == (f.kernel_size, f.stride, f.img_shape)
    calls = _count_kernel_convs(monkeypatch)
    model = NexToU(spec, conv_kernel=mode).eval()
    with torch.no_grad():
        out = model(torch.zeros(1, *spec.patch_size, 1))
    assert out.shape == (1, *spec.patch_size, 2)
    assert [(c // 3, co // 3, s, sp) for c, co, s, sp in calls] == want
    # the full-width flagship routes the same convs: widths enter only here
    widths = {E1A: (33, 66), E1B: (66, 66), E2A: (66, 132), D1A: (132, 66), D1B: (66, 66)}
    for key, (c, co) in widths.items():
        assert conv_kernel_wins(key[3], c, co, (3, 3, 3), key[2])
    with pytest.raises(ValueError):
        NexToU(spec, conv_kernel="2")


def _region_of_every_333_conv(monkeypatch):
    """small_3d_spec's convs are too small for the kernel's region: let the
    region take every (3, 3, 3) conv, so that each one runs the kernel path."""
    monkeypatch.setattr(conv_blocks, "conv_kernel_wins",
                        lambda sp, c, co, kernel, stride: tuple(kernel) == (3, 3, 3))


def _halved(model):
    with torch.no_grad():  # as tests/test_torch_model.py: keeps eval logits in range
        for p in model.parameters():
            if p.dim() >= 2:
                p.mul_(0.5)
    return model


def _tiny_spec():
    """The five-stage network of tests/test_torch_train.py (about 2,000 kNN
    rows per forward), every conv (3, 3, 3): small enough that no kNN
    selection is a near tie, which under batch statistics would move every
    gradient by percents."""
    return build_model_spec(
        in_channels=1, patch_size=(8, 16, 16), n_stages=5,
        features_per_stage=[4, 6, 6, 6, 6], kernel_sizes=[(3, 3, 3)] * 5,
        strides=[(1, 1, 1), (2, 2, 2), (2, 2, 2), (1, 1, 1), (1, 1, 1)],
        n_conv_per_stage=[2] * 5, n_conv_per_stage_decoder=[2] * 4,
        num_classes=3, deep_supervision=True,
    )


def _one_train_step(spec, mode, batch, seed, remat=False):
    model = NexToU(spec, conv_kernel=mode, remat=remat)
    opt = make_optimizer(1e-2)
    state = create_train_state(model, opt, seed=seed)
    before = torch.cat([p.detach().flatten().clone() for p in model.parameters()])
    step = make_train_step(model, opt, CompoundLossSpec(), deep_supervision_weights(len(spec.decoder)))
    state, metrics = step(state, batch)
    after = torch.cat([p.detach().flatten() for p in model.parameters()])
    return metrics["loss"].item(), metrics["grad_norm"].item(), after - before


def test_small_network_with_the_kernel_on_matches_off(monkeypatch):
    """Eval logits of small_3d in f32: atol 1e-4 (measured 1.3e-5 at logits
    up to 0.26: the conv's sum runs in another order, nothing else differs).
    That holds while no kNN near tie flips under the reordered sum: with
    other seeds one does, and then up to 5% of the logits move by up to 1e-3.

    One train step of the tiny network from the same state and batch: loss
    rtol 1e-5 (measured 3.3e-6), gradient norm rtol 2e-3 (4.7e-4), and the
    update, which is the clipped gradient times the rate, within 1% of its
    L2 norm (0.31%) and atol 2e-4 per value (1.1e-4 at values up to 2.5e-2).
    On small_3d the step is chaotic (a flipped row moves every gradient, see
    tests/test_torch_train.py): its loss moves by 1e-3 and its update by more
    than its norm."""
    _region_of_every_333_conv(monkeypatch)
    calls = _count_kernel_convs(monkeypatch)
    spec = presets.small_3d_spec(deep_supervision=False)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, *spec.patch_size, 1)).astype(np.float32))
    models = {m: _halved(init_weights(NexToU(spec, conv_kernel=m), seed=3)).eval() for m in "01"}
    with torch.no_grad():
        off, on = models["0"](x), models["1"](x)
    assert len(calls) == 11  # every conv of stages 1-5 and of decoder stages 0-3
    np.testing.assert_allclose(on.numpy(), off.numpy(), rtol=0, atol=1e-4)
    assert not torch.equal(on, off)  # another path did run

    spec = _tiny_spec()
    batch = {"data": rng.standard_normal((2, *spec.patch_size, 1)).astype(np.float32),
             "seg": rng.integers(0, 3, (2, *spec.patch_size))}
    calls.clear()
    loss1, norm1, update1 = _one_train_step(spec, "1", batch, seed=3)
    assert len(calls) == 11  # 6 encoder and 5 decoder convs, all (3, 3, 3)
    loss0, norm0, update0 = _one_train_step(spec, "0", batch, seed=3)
    assert len(calls) == 11
    assert abs(loss1 - loss0) <= 1e-5 * abs(loss0)
    assert abs(norm1 - norm0) <= 2e-3 * abs(norm0)
    assert (update1 - update0).norm() <= 1e-2 * update0.norm()
    torch.testing.assert_close(update1, update0, rtol=0, atol=2e-4)


def test_recomputed_stage_runs_the_kernel_again(monkeypatch):
    _region_of_every_333_conv(monkeypatch)
    calls = _count_kernel_convs(monkeypatch)
    spec = _tiny_spec()
    rng = np.random.default_rng(1)
    batch = {"data": rng.standard_normal((2, *spec.patch_size, 1)).astype(np.float32),
             "seg": rng.integers(0, 3, (2, *spec.patch_size))}
    once = _one_train_step(spec, "1", batch, seed=5)
    assert len(calls) == 11
    calls.clear()
    twice = _one_train_step(spec, "1", batch, seed=5, remat=True)
    assert len(calls) == 2 * 11
    # the recomputed forward repeats the first: the same step, bit for bit
    assert once[:2] == twice[:2] and torch.equal(once[2], twice[2])


def test_conv_block_adds_the_bias_after_the_kernel(monkeypatch):
    _region_of_every_333_conv(monkeypatch)
    torch.manual_seed(0)
    on = ConvNormAct(5, 7, (3, 3, 3), (1, 2, 2), conv_kernel="1").eval()
    off = ConvNormAct(5, 7, (3, 3, 3), (1, 2, 2)).eval()
    with torch.no_grad():
        on.conv.bias.normal_()
    off.load_state_dict(on.state_dict())
    x = torch.randn(2, 5, 4, 8, 10)
    calls = _count_kernel_convs(monkeypatch)
    with torch.no_grad():
        torch.testing.assert_close(on(x), off(x), rtol=0, atol=1e-5)
        assert len(calls) == 1
        # a (1, 3, 3) conv or a 2D conv never goes to the kernel
        ConvNormAct(5, 7, (1, 3, 3), (1, 1, 1), conv_kernel="1").eval()(x)
        ConvNormAct(5, 7, (3, 3), (1, 1), conv_kernel="1").eval()(x[:, :, 0])
    assert len(calls) == 1


def test_probe_plain_version_matches_the_numpy_oracle():
    x, w = exp_conv_probe.probe_inputs()
    want = exp_conv_probe.numpy_oracle(x, w)
    assert want.shape == (exp_conv_probe.TH, exp_conv_probe.W, exp_conv_probe.CO)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = exp_conv_probe.conv_probe_reference(xt, wt, False).numpy()
    got_t = exp_conv_probe.conv_probe_reference(xt, wt, True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_t.transpose(0, 2, 1), want, rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        exp_conv_probe.conv_probe_cuda(xt, wt, False)  # a CPU tensor never launches


@pytest.mark.parametrize("tool", [
    "exp_conv_v2", "exp_conv_probe", "exp_knn_dissect", "exp_conv_kernel", "profile_forward",
    "profile_train",
])
def test_tools_fail_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where there is no card")
    proc = subprocess.run([sys.executable, "-m", f"nextou_tpu_torch.tools.{tool}"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "no CUDA card" in proc.stderr
    assert proc.stdout == ""
