"""The frozen reference against nextou_tpu_torch on the CPU, at small sizes:
the same network spec, every conv stack, grapher and FFN of both families
forward in training and eval mode, the first step's loss and the optimizer's
update, the relative-position tables, and the loader's augmented batches.

A grapher's selection splits a near tie of its k-th and (k+1)-th candidates
by rounding: a change of 1e-6 in its input (a conv of a non-contiguous
tensor) moves a pooled grapher's output by 0.06 on 0.1% of its values at
these widths, on either side alone. So a part's values agree within 5e-5 but
for at most 3% of them, and a whole network's loss within 1%."""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import pytest
import torch

from h100_bench import bench, synthetic
from h100_bench.reference.spec import spec_from_config
from h100_bench.reference import data as ref_data
from h100_bench.reference import losses as ref_losses
from h100_bench.reference import network as ref_net
from h100_bench.reference.posembed import relative_pos_bias as ref_table
from h100_bench.reference.sgd import sgd_step
from h100_bench.reference.spec import build_model_spec
from h100_bench.weights import load_into, make_weights, running_stats
from nextou_tpu_torch.core.pos_embed import relative_pos_bias
from nextou_tpu_torch.losses import deep_supervised_loss, dc_ce_ti_loss
from nextou_tpu_torch.models import NexToU
from nextou_tpu_torch.models.spec import build_model_spec as port_spec
from nextou_tpu_torch.train import get_trainer_class, make_optimizer

SMALL_3D = dict(in_channels=1, patch_size=(16, 112, 96), n_stages=6,
                features_per_stage=[12, 24, 48, 48, 48, 48],
                kernel_sizes=[(1, 3, 3)] + [(3, 3, 3)] * 5,
                strides=[(1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2), (1, 1, 1)],
                n_conv_per_stage=[2] * 6, n_conv_per_stage_decoder=[2] * 5, num_classes=3)
SMALL_2D = dict(in_channels=1, patch_size=(256, 256), n_stages=7,
                features_per_stage=[8, 16, 32, 64, 64, 64, 64], kernel_sizes=[(3, 3)] * 7,
                strides=[(1, 1)] + [(2, 2)] * 6, n_conv_per_stage=[2] * 7,
                n_conv_per_stage_decoder=[2] * 6, num_classes=3)


def pair(kwargs, seed=3, ds=True):
    rspec = build_model_spec(**kwargs, deep_supervision=ds)
    pspec = port_spec(**kwargs, deep_supervision=ds)
    assert dataclasses.asdict(rspec) == dataclasses.asdict(pspec)
    ref, port = ref_net.NexToU(rspec), NexToU(pspec)
    w = make_weights([(n, tuple(p.shape)) for n, p in ref.named_parameters()], seed, "cpu")
    load_into(ref, w)
    load_into(port, w)
    return ref, port


@pytest.mark.parametrize("kwargs", [SMALL_3D, SMALL_2D], ids=["3d", "2d"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_stages_and_graphers_agree(kwargs, training):
    ref, port = pair(kwargs)
    x = torch.randn(2, *kwargs["patch_size"], 1, generator=torch.Generator().manual_seed(1))
    if not training:
        with torch.no_grad():
            ref(x, training=True, calibrate=True)
        load_into(port, {n: p.detach() for n, p in ref.named_parameters()}, running_stats(ref))
    port.train(training)
    ctx = ref_net._Ctx(ref_net.Precision(), training)
    worst = 0.0

    def held(a, b):
        nonlocal worst
        worst = max(worst, ((a - b).abs() > 5e-5).float().mean().item())

    def stage(ps, rs, h):
        """Each part of a stage on the port's input to it: the conv stack,
        then each grapher and FFN channels-last."""
        hybrid = isinstance(rs, torch.nn.Sequential)
        pc, rc = (ps[0], rs[0]) if hybrid else (ps, rs)
        out = pc(h)
        held(out, rc(h, ctx))
        if not hybrid:
            return out
        out = out.movedim(1, -1)
        for pb, rb in zip(list(ps)[1:], list(rs)[1:]):
            for pm, rm in zip(pb.blocks[0], rb.blocks[0]):
                nxt = pm(out)
                held(nxt, rm(out, ctx))
                out = nxt
        return out.movedim(-1, 1)

    with torch.no_grad():
        h = x.movedim(-1, 1).contiguous()
        skips = []
        for ps, rs in zip(port.encoder.stages, ref.encoder.stages):
            h = stage(ps[0], rs[0], h)
            skips.append(h)
        for i, (ps, up, rs) in enumerate(zip(port.decoder.stages, port.decoder.transpconvs,
                                             ref.decoder.stages)):
            conv_t = torch.nn.functional.conv_transpose3d if h.dim() == 5 else \
                torch.nn.functional.conv_transpose2d
            h = stage(ps, rs, torch.cat([conv_t(h, up.weight, up.bias, up.stride),
                                         skips[-(i + 2)]], 1))
    assert worst <= 0.03


@pytest.mark.parametrize("kwargs", [SMALL_3D, SMALL_2D], ids=["3d", "2d"])
def test_first_loss_and_update_agree(kwargs):
    ref, port = pair(kwargs)
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, *kwargs["patch_size"], 1, generator=gen)
    y = torch.randint(0, 3, (2, *kwargs["patch_size"]), generator=gen)
    cfg = {"weight_ce": 1.0, "weight_dice": 1.0, "weight_ti": 1e-4, "connectivity":
           3 ** len(kwargs["patch_size"]) - 1, "batch_dice": True, "exclusion": [[1, 2]]}
    from nextou_tpu_torch.losses import CompoundLossSpec, TILossSpec
    spec = CompoundLossSpec(weight_ti=1e-4, ti=TILossSpec.create(
        dim=len(kwargs["patch_size"]), connectivity=cfg["connectivity"], exclusion=[[1, 2]]))
    port.train()
    outs = port(x)
    lp = deep_supervised_loss(outs, y, lambda o, t: dc_ce_ti_loss(o, t, spec))
    assert lp.item() == pytest.approx(ref_losses.deep_supervised(outs, y, cfg).item(), rel=1e-6)
    lr = ref_losses.deep_supervised(ref(x, training=True), y, cfg)
    assert lp.item() == pytest.approx(lr.item(), rel=1e-2)
    # one optimizer update from the same gradient
    params = list(ref.parameters())
    grads = [torch.randn(p.shape, generator=gen) * 0.1 for p in params]
    mine = [p.detach().clone() for p in params]
    theirs = [p.detach().clone() for p in params]
    sgd_step(mine, [g.clone() for g in grads], [torch.zeros_like(p) for p in mine], 0)
    make_optimizer(1e-2).update([g.clone() for g in grads], [torch.zeros_like(p) for p in theirs],
                                theirs, 0)
    assert max((a - b).abs().max().item() for a, b in zip(mine, theirs)) < 1e-6


@pytest.mark.parametrize("args", [(132, 168, 168, 3), (264, 1344, 168, 3), (256, 56, 56, 2),
                                  (256, 896, 224, 2)])
def test_relative_position_tables_agree(args):
    want = relative_pos_bias(*args)
    got = ref_table(*args).numpy()
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


@pytest.mark.parametrize("config,traffic,plans", [
    ("nextou_3d_btcv", {"generator": "ct", "cases": 3, "shape": [24, 80, 80]},
     {"batch_size": 2, "patch_size": [16, 64, 64], "UNet_base_num_features": 12,
      "unet_max_num_features": 24,
      "pool_op_kernel_sizes": [[1, 1, 1], [1, 2, 2], [1, 2, 2], [2, 2, 2], [2, 2, 2], [1, 1, 1]]}),
    ("nextou_2d_ravir", {"generator": "retina", "cases": 3, "shape": [200, 200]},
     {"batch_size": 3, "patch_size": [128, 128], "UNet_base_num_features": 8,
      "unet_max_num_features": 32}),
], ids=["3d", "2d"])
def test_loader_batches_worked_out_again(tmp_path, config, traffic, plans):
    from nextou_tpu_torch.data.device_augment import device_augment_batch

    cfg = copy.deepcopy(bench.load("configs", config))
    cfg["plans"].update(plans)
    seed = 2**31 + 11
    cases = synthetic.make_cases(traffic, cfg, seed, "cpu")
    ids = synthetic.write_dataset(str(tmp_path), cases, cfg, seed)
    trainer = get_trainer_class(cfg["trainer"])(
        {"configurations": {cfg["configuration"]: cfg["plans"]}}, cfg["configuration"], 0,
        cfg["dataset_json"], preprocessed_folder=str(tmp_path),
        output_folder=str(tmp_path / "out"), device="cpu", seed=seed, device_da=True)
    trainer.initialize()
    assert dataclasses.asdict(trainer.model_spec) == dataclasses.asdict(spec_from_config(cfg, True))
    loader, _ = trainer.get_dataloaders()
    want = ref_data.batches(synthetic.read_cases(str(tmp_path), ids),
                            ref_data.aug_for_patch(plans["patch_size"]), plans["batch_size"],
                            cfg["oversample_foreground"], seed, cfg["loader_threads"], 4)
    aug = trainer._augment_config()
    with loader:
        it = iter(loader)
        for data, seg in want:
            b = next(it)
            got, got_seg, _ = device_augment_batch(b["data"], b["seg"], b["plans"], aug)
            assert np.abs(got.movedim(1, -1).numpy() - data).max() < 1e-5
            assert np.array_equal(got_seg.long().numpy(), seg)
