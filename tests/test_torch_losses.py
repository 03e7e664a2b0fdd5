"""The port's losses against ``nextou_tpu.losses``, on the CPU.

The same logits and labels, made with numpy from a seed, go through both
packages in f32. Tolerance of the loss values: rtol 1e-5 / atol 1e-6 (the
sums run in another order); the TI/BTI critical maps are integer work and
must be bit-identical; gradients with respect to the logits within rtol 1e-4 /
atol 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextou_tpu import losses as jl
from nextou_tpu.losses.compound import region_targets as jax_region_targets
from nextou_tpu.losses.dice import region_soft_dice_loss as jax_region_dice
from nextou_tpu_torch import losses as pl

# the BTCV/Synapse binary interaction tree of nnUNetTrainer_NexToU_BTI_Synapse
SYNAPSE_EXCLUSION = [
    [[1, 3, 5, 7, 8, 11, 13], [2, 4, 6, 9, 10, 12]],
    [[1, 3, 11, 13], [5, 7, 8]],
    [[1, 3], [11, 13]],
    [1, 3],
    [11, 13],
    [[5, 8], [7]],
    [5, 8],
    [[4, 6, 10], [2, 9, 12]],
    [[4, 6], [10]],
    [4, 6],
    [[9, 12], [2]],
    [9, 12],
]
RTOL, ATOL = 1e-5, 1e-6


def _data(shape, classes, seed, ignore=None):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((*shape, classes))).astype(np.float32)
    target = rng.integers(0, classes, shape).astype(np.int32)
    if ignore is not None:
        target[rng.random(shape) < 0.2] = ignore
    return logits, target


def _blobs(shape, classes, seed):
    """A label map of blocky regions, so that classes touch along surfaces."""
    rng = np.random.default_rng(seed)
    coarse = rng.integers(0, classes, [2] + [-(-s // 4) for s in shape[1:]])
    for axis in range(1, len(shape)):
        coarse = np.repeat(coarse, 4, axis=axis)
    return coarse[(slice(None), *[slice(0, s) for s in shape[1:]])].astype(np.int32)


def _both(port_fn, jax_fn, logits, *args):
    """Loss values and logits-gradients of both packages."""
    lt = torch.from_numpy(logits).requires_grad_()
    got = port_fn(lt, *[torch.from_numpy(a) for a in args])
    got.backward()
    want, wgrad = jax.value_and_grad(jax_fn)(jnp.asarray(logits), *[jnp.asarray(a) for a in args])
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(wgrad), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("ignore", [None, 3])
def test_cross_entropy_matches_jax(ignore):
    logits, target = _data((2, 6, 10, 8), 4, 0, ignore)
    np.testing.assert_allclose(
        pl.cross_entropy_elementwise(torch.from_numpy(logits), torch.from_numpy(target)).numpy(),
        np.asarray(jl.ce.cross_entropy_elementwise(jnp.asarray(logits), jnp.asarray(target))),
        rtol=RTOL, atol=ATOL,
    )
    _both(lambda l, t: pl.cross_entropy_loss(l, t, ignore_index=ignore),
          lambda l, t: jl.cross_entropy_loss(l, t, ignore_index=ignore), logits, target)


@pytest.mark.parametrize("batch_dice", [False, True])
@pytest.mark.parametrize("do_bg", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_soft_dice_matches_jax(batch_dice, do_bg, masked):
    logits, target = _data((2, 6, 10, 8), 4, 1)
    kw = dict(batch_dice=batch_dice, do_bg=do_bg, smooth=1e-5)
    if not masked:
        _both(lambda l, t: pl.soft_dice_loss(l, t, **kw),
              lambda l, t: jl.soft_dice_loss(l, t, **kw), logits, target)
        return
    # a non-binary mask shows that it enters each term once
    mask = np.random.default_rng(2).random(target.shape).astype(np.float32)
    _both(lambda l, t, m: pl.soft_dice_loss(l, t, loss_mask=m, **kw),
          lambda l, t, m: jl.soft_dice_loss(l, t, loss_mask=m, **kw), logits, target, mask)


@pytest.mark.parametrize("batch_dice", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_region_dice_matches_jax(batch_dice, masked):
    logits, target = _data((2, 6, 10, 8), 3, 3)
    regions = ((1, 2, 3), (2, 3), (3,))
    tgt = np.asarray(jax_region_targets(jnp.asarray(target), regions))
    np.testing.assert_array_equal(
        pl.region_targets(torch.from_numpy(target), regions).numpy(), tgt
    )
    tgt = tgt.astype(np.float32)
    kw = dict(batch_dice=batch_dice, smooth=1e-5)
    if masked:
        mask = (np.random.default_rng(4).random(target.shape) < 0.7).astype(np.float32)
        _both(lambda l, t, m: pl.region_soft_dice_loss(l, t, loss_mask=m, **kw),
              lambda l, t, m: jax_region_dice(l, t, loss_mask=m, **kw), logits, tgt, mask)
    else:
        _both(lambda l, t: pl.region_soft_dice_loss(l, t, **kw),
              lambda l, t: jax_region_dice(l, t, **kw), logits, tgt)


TI_CASES = {
    "ti_2d_4": (2, 4, [], [[1, 2], [1, 3], [2, 3]], (2, 24, 20), 4),
    "ti_2d_8_inclusion": (2, 8, [[1, 2]], [[2, 3]], (2, 24, 20), 4),
    "ti_3d_6": (3, 6, [[2, 1]], [[1, 3]], (2, 8, 12, 12), 4),
    "bti_3d_26_synapse": (3, 26, [], SYNAPSE_EXCLUSION, (2, 8, 16, 12), 14),
}


@pytest.mark.parametrize("name", list(TI_CASES))
def test_critical_maps_are_bit_identical(name):
    dim, conn, inclusion, exclusion, shape, classes = TI_CASES[name]
    jspec = jl.TILossSpec.create(dim, conn, inclusion, exclusion)
    spec = pl.TILossSpec.create(dim, conn, inclusion, exclusion)
    assert spec.interactions == jspec.interactions
    for seed, make in ((0, _blobs), (1, lambda s, c, seed: _data(s, c, seed)[1])):
        p = make(shape, classes, seed)
        want = np.asarray(jl.critical_voxels_map(jnp.asarray(p), jspec))
        got = pl.critical_voxels_map(torch.from_numpy(p), spec)
        assert got.dtype == torch.float32 and 0 < want.mean() < 1
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(TI_CASES))
@pytest.mark.parametrize("masked", [False, True])
def test_ti_loss_matches_jax(name, masked):
    dim, conn, inclusion, exclusion, shape, classes = TI_CASES[name]
    jspec = jl.TILossSpec.create(dim, conn, inclusion, exclusion)
    spec = pl.TILossSpec.create(dim, conn, inclusion, exclusion)
    logits, _ = _data(shape, classes, 5)
    target = _blobs(shape, classes, 6)
    # logits that mostly follow a blocky map: the argmax map has surfaces
    logits += 4.0 * np.eye(classes, dtype=np.float32)[_blobs(shape, classes, 7)]
    if masked:
        mask = np.random.default_rng(8).random(shape) < 0.7
        _both(lambda l, t, m: pl.ti_loss(l, t, spec, loss_mask=m),
              lambda l, t, m: jl.ti_loss(l, t, jspec, loss_mask=m), logits, target, mask)
    else:
        _both(lambda l, t: pl.ti_loss(l, t, spec),
              lambda l, t: jl.ti_loss(l, t, jspec), logits, target)


def _specs(**kw):
    ti = kw.pop("ti", None)
    jti = pti = None
    if ti is not None:
        jti, pti = jl.TILossSpec.create(*ti), pl.TILossSpec.create(*ti)
    return jl.CompoundLossSpec(ti=jti, **kw), pl.CompoundLossSpec(ti=pti, **kw)


COMPOUND_CASES = {
    "dice_ce": dict(),
    "dice_ce_no_batch_dice": dict(batch_dice=False),
    "ignore_label": dict(ignore_label=4),
    "ti": dict(weight_ti=1e-4, ti=(3, 26, [], [[1, 2], [2, 3]])),
    "ti_ignore_label": dict(weight_ti=1e-4, ti=(3, 6, [[1, 2]], [[2, 3]]), ignore_label=4),
    "regions": dict(regions=((1, 2, 3), (2, 3), (3,))),
    "regions_ignore_label": dict(regions=((1, 2, 3), (2, 3), (3,)), ignore_label=4),
    "ce_only": dict(weight_dice=0.0),
}


@pytest.mark.parametrize("name", list(COMPOUND_CASES))
def test_compound_loss_matches_jax(name):
    kw = COMPOUND_CASES[name]
    jspec, spec = _specs(**kw)
    classes = 3 if "regions" in kw else 4
    logits, target = _data((2, 8, 12, 10), classes, 9, kw.get("ignore_label"))
    if "regions" in kw:
        target = np.where(target == 4, 4, np.random.default_rng(1).integers(0, 4, target.shape))
        target = target.astype(np.int32)
    _both(lambda l, t: pl.dc_ce_ti_loss(l, t, spec),
          lambda l, t: jl.dc_ce_ti_loss(l, t, jspec), logits, target)


def test_regions_with_ti_is_refused():
    _, spec = _specs(regions=((1,), (2,)), weight_ti=1e-6, ti=(3, 26, [], [[1, 2]]))
    with pytest.raises(NotImplementedError):
        pl.dc_ce_ti_loss(torch.zeros(1, 4, 4, 4, 2), torch.zeros(1, 4, 4, 4, dtype=torch.long), spec)


@pytest.mark.parametrize("n", [1, 2, 5])
def test_deep_supervision_weights_match_jax(n):
    np.testing.assert_array_equal(pl.deep_supervision_weights(n), jl.deep_supervision_weights(n))


def test_deep_supervised_loss_matches_jax():
    shapes = [(8, 16, 12), (8, 8, 6), (4, 4, 3), (2, 2, 3)]
    rng = np.random.default_rng(10)
    outs = [rng.standard_normal((2, *s, 4)).astype(np.float32) for s in shapes]
    target = rng.integers(0, 4, (2, *shapes[0])).astype(np.int32)
    jspec, spec = _specs(weight_ti=1e-4, ti=(3, 26, [], [[1, 2], [1, 3]]))
    for s in shapes:
        np.testing.assert_array_equal(
            pl.downsample_target(torch.from_numpy(target), s).numpy(),
            np.asarray(jl.downsample_target(jnp.asarray(target), s)),
        )
    weights = pl.deep_supervision_weights(len(outs))
    assert weights[-1] == 0

    outs_t = [torch.from_numpy(o).requires_grad_() for o in outs]
    got = pl.deep_supervised_loss(
        outs_t, torch.from_numpy(target), lambda o, t: pl.dc_ce_ti_loss(o, t, spec), weights
    )
    got.backward()
    want, wgrads = jax.value_and_grad(lambda os: jl.deep_supervised_loss(
        os, jnp.asarray(target), lambda o, t: jl.dc_ce_ti_loss(o, t, jspec), weights
    ))([jnp.asarray(o) for o in outs])
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL, atol=ATOL)
    assert outs_t[-1].grad is None and not np.any(np.asarray(wgrads[-1]))  # weight 0: skipped
    for o, w in zip(outs_t[:-1], wgrads):
        np.testing.assert_allclose(o.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-7)
    with pytest.raises(ValueError):
        pl.downsample_target(torch.from_numpy(target), (3, 16, 12))
