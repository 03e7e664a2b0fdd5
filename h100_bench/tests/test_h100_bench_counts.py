"""The benchmark's work counts: the analytic FLOP count against
``FlopCounterMode`` over the reference's convs and matmuls, the kNN calls of
both full networks against a fixed table, and their bounds."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import flops, roofline
from h100_bench.reference.network import NexToU
from h100_bench.reference.spec import build_model_spec

SMALL_3D = dict(in_channels=1, patch_size=(16, 112, 96), n_stages=6,
                features_per_stage=[12, 24, 48, 48, 48, 48],
                kernel_sizes=[(1, 3, 3)] + [(3, 3, 3)] * 5,
                strides=[(1, 1, 1), (1, 2, 2), (1, 2, 2), (2, 2, 2), (2, 2, 2), (1, 1, 1)],
                n_conv_per_stage=[2] * 6, n_conv_per_stage_decoder=[2] * 5, num_classes=3)
SMALL_2D = dict(in_channels=1, patch_size=(256, 256), n_stages=7,
                features_per_stage=[4, 8, 8, 16, 32, 32, 32], kernel_sizes=[(3, 3)] * 7,
                strides=[(1, 1)] + [(2, 2)] * 6, n_conv_per_stage=[2] * 7,
                n_conv_per_stage_decoder=[2] * 6, num_classes=3)
FLAGSHIP = dict(in_channels=1, patch_size=(64, 224, 192), n_stages=6,
                features_per_stage=[33, 66, 132, 264, 324, 324],
                kernel_sizes=[(1, 3, 3)] + [(3, 3, 3)] * 5,
                strides=[(1, 1, 1), (1, 2, 2)] + [(2, 2, 2)] * 4, n_conv_per_stage=[2] * 6,
                n_conv_per_stage_decoder=[2] * 5, num_classes=14)
RAVIR = dict(in_channels=1, patch_size=(512, 448), n_stages=7,
             features_per_stage=[32, 64, 128, 256, 512, 512, 512], kernel_sizes=[(3, 3)] * 7,
             strides=[(1, 1)] + [(2, 2)] * 6, n_conv_per_stage=[2] * 7,
             n_conv_per_stage_decoder=[2] * 6, num_classes=3)

# (B, N, M, C, k, self_graph) -> calls per forward: chip_smoke.py::knn_calls of the
# flagship at batch 4 and of ravir_2d_spec at batch 4
KNN_FLAGSHIP_4 = {
    (4, 10752, 168, 132, 14, False): 2, (2048, 168, 168, 132, 7, True): 2,
    (4, 10752, 1344, 264, 28, False): 2, (256, 168, 168, 264, 14, True): 2,
    (4, 1344, 1344, 324, 32, True): 2, (32, 168, 168, 324, 14, True): 2,
    (4, 168, 168, 324, 32, True): 1, (4, 168, 168, 324, 28, True): 1,
}
KNN_RAVIR_4 = {
    (4, 896, 224, 256, 28, False): 2, (256, 56, 56, 256, 7, True): 2,
    (4, 896, 896, 512, 32, True): 2, (64, 56, 56, 512, 14, True): 2,
    (4, 224, 224, 512, 32, True): 2, (16, 56, 56, 512, 14, True): 2,
    (4, 56, 56, 512, 32, True): 1, (4, 56, 56, 512, 28, True): 1,
}


@pytest.mark.parametrize("kwargs", [SMALL_3D, SMALL_2D], ids=["3d", "2d"])
@pytest.mark.parametrize("ds", [True, False], ids=["ds", "no_ds"])
def test_flops_match_the_counter(kwargs, ds):
    spec = build_model_spec(**kwargs, deep_supervision=ds)
    net = NexToU(spec)
    x = torch.randn(2, *spec.patch_size, 1)
    with torch.no_grad():
        net(x, training=True)  # builds the relative-position tables, which are not counted
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(x, training=True)
    assert counter.get_total_flops() == 2 * flops.forward_flops(spec)


@pytest.mark.parametrize("kwargs,table", [(FLAGSHIP, KNN_FLAGSHIP_4), (RAVIR, KNN_RAVIR_4)],
                         ids=["flagship", "ravir"])
def test_knn_calls_of_the_full_networks(kwargs, table):
    assert roofline.knn_calls(build_model_spec(**kwargs), 4) == table


def test_bounds_and_flops_of_the_full_networks():
    flag, ravir = build_model_spec(**FLAGSHIP), build_model_spec(**RAVIR)
    # K1 per batch-4 forward; K3 + K4 per train step (chip_smoke.py's bounds)
    assert roofline.knn_bound_ms(flag, 4, False) == pytest.approx(0.397, abs=5e-4)
    assert roofline.knn_bound_ms(flag, 2, True) == pytest.approx(0.411 + 0.302, abs=1e-3)
    assert roofline.knn_bound_ms(ravir, 4, False) == pytest.approx(0.046, abs=5e-4)
    assert roofline.knn_bound_ms(ravir, 12, True) == pytest.approx(0.255 + 0.229, abs=1e-3)
    # within 2% of XLA's count of the JAX forward (1.529 TFLOP per flagship patch)
    assert flops.forward_flops(flag) == pytest.approx(1.529e12, rel=0.02)
