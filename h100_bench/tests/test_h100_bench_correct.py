"""``correct`` comes out false where it should: the control (the reference in
float8 e4m3 in the program's place) fails a cell's limits, and a whole run on
the CPU, the harness's look for a card skipped, fails with the timed path
broken underneath: a train step that leaves its state unchanged, a train
step that leaves out half of its batch (the mean taken over the rest), a
served segmentation altered where it is produced."""

from __future__ import annotations

import copy

import pytest
import torch

from h100_bench import bench

TRAIN_3D = dict(
    config="nextou_3d_btcv", traffic={"generator": "ct", "cases": 3, "shape": [24, 80, 80]},
    cell={"name": "btcv3d_train", "mode": "train", "check_steps": 3, "warmup_steps": 1,
          "trace_units": 2},
    plans={"batch_size": 2, "patch_size": [16, 64, 64], "UNet_base_num_features": 12,
           "unet_max_num_features": 48,
           "pool_op_kernel_sizes": [[1, 1, 1], [1, 2, 2], [1, 2, 2], [2, 2, 2], [2, 2, 2],
                                    [1, 1, 1]]})
TRAIN_2D = dict(
    config="nextou_2d_ravir", traffic={"generator": "retina", "cases": 3, "shape": [200, 200]},
    cell={"name": "ravir2d_train", "mode": "train", "check_steps": 3, "warmup_steps": 1,
          "trace_units": 2},
    plans={"batch_size": 4, "patch_size": [128, 128], "UNet_base_num_features": 16,
           "unet_max_num_features": 64})
SERVE_2D = dict(
    config="nextou_2d_ravir", traffic={"generator": "retina", "cases": 2, "shape": [160, 160]},
    cell={"name": "ravir2d_serve", "mode": "serve", "tile_batch": 2, "check_cases": 2,
          "trace_units": 2},
    plans={"patch_size": [128, 128], "UNet_base_num_features": 16, "unet_max_num_features": 64})
SERVE_3D = dict(
    config="nextou_3d_btcv", traffic={"generator": "ct", "cases": 1, "shape": [20, 72, 72]},
    cell={"name": "btcv3d_serve", "mode": "serve", "tile_batch": 2, "check_cases": 1,
          "trace_units": 2},
    plans={"patch_size": [16, 64, 64], "UNet_base_num_features": 12, "unet_max_num_features": 48,
           "pool_op_kernel_sizes": [[1, 1, 1], [1, 2, 2], [1, 2, 2], [2, 2, 2], [2, 2, 2],
                                    [1, 1, 1]]})


def make_run(case, seed=2**31 + 101, seconds=1.0) -> bench.Run:
    """A run of a small copy of a cell on the CPU: the configuration's file
    with a smaller patch and narrower widths, device augmentation on."""
    torch.set_num_threads(4)
    cfg = copy.deepcopy(bench.load("configs", case["config"]))
    cfg["plans"].update(case["plans"])
    cfg["preset"], cfg["device_da"] = None, True
    cell = {"config": case["config"], "chips": 1, **case["cell"]}
    e2e, per_layer = bench.cell_metrics(bench.benchmark(), case["cell"]["name"])
    return bench.Run(case["cell"]["name"], cell, cfg, case["traffic"], seed, seconds, False,
                     torch.device("cpu"), e2e, per_layer)


def failed_numbers(result) -> dict:
    return {n: c["value"] for n, c in result["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("case", [TRAIN_3D, TRAIN_2D], ids=["3d", "2d"])
def test_train_control_fails(case):
    from h100_bench.modes.train import Cell

    run = make_run(case)
    cell = Cell(run)
    cell.setup()
    cell.window(0.1)
    cell.release()
    try:
        ref = cell.reference_readings()
        gaps = Cell.gaps(cell.reference_readings("fp8"), ref)
    finally:
        cell.close()
    limits = run.config["limits"]["train"]
    assert any(gaps[n] > limit for n, limit in limits.items()), gaps


@pytest.mark.parametrize("case", [SERVE_2D, SERVE_3D], ids=["2d", "3d"])
def test_serve_control_fails(case):
    from h100_bench.calibrate import control
    from h100_bench.modes.serve import Cell

    run = make_run(case)
    cell = Cell(run)
    cell.setup()
    cell.window(0.1)
    cell.release()
    cell.check()
    gaps = control(cell, "serve")
    limits = run.config["limits"]["serve"]
    assert any(gaps[n] > limit for n, limit in limits.items()), gaps


def test_train_state_left_unchanged_fails(monkeypatch):
    from nextou_tpu_torch.train.optimizer import SGD

    def no_update(self, grads, momentum, params, step):
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(grads))))

    monkeypatch.setattr(SGD, "update", no_update)
    result = bench.run_cell(make_run(TRAIN_2D))
    assert not result["correct"]
    assert result["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_fails(monkeypatch):
    from nextou_tpu_torch.train import train_step as ts

    from h100_bench.calibrate import half_batch

    monkeypatch.setattr(ts, "_batch_on", ts._batch_on)
    half_batch()
    result = bench.run_cell(make_run(TRAIN_2D))
    assert not result["correct"]
    assert "loss_gap" in failed_numbers(result)


def test_served_answer_altered_fails(monkeypatch):
    import nextou_tpu_torch.predict as predict

    build = predict.build_predictor

    def altered(*args, **kwargs):
        fn = build(*args, **kwargs)

        def predict_case(data):
            seg = fn(data).copy()
            seg[: seg.shape[0] // 4] = (seg[: seg.shape[0] // 4] + 1) % 3
            return seg
        return predict_case

    monkeypatch.setattr(predict, "build_predictor", altered)
    result = bench.run_cell(make_run(SERVE_2D))
    assert not result["correct"]
    assert set(failed_numbers(result)) == set(result["checks"])


@pytest.mark.parametrize("case", [TRAIN_2D, SERVE_2D, SERVE_3D], ids=["train_2d", "serve_2d",
                                                                      "serve_3d"])
def test_sound_runs_are_correct(case):
    result = bench.run_cell(make_run(case))
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
