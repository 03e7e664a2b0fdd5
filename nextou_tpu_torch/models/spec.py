"""The NexToU shape program: a pure ``plans -> ModelSpec`` function.

Carried over unchanged from ``nextou_tpu/models/spec.py``: importing that
module would load flax through ``nextou_tpu/models/__init__.py``.

The reference derives every architectural hyperparameter (stage split,
k-schedules, window/shift sizes, pooling decisions, reduce ratios) inside its
module constructors (``NexToU_Encoder_Decoder.py:34-185,935-1092``). Here that
derivation is a standalone, hashable specification — the model is a thin
interpreter over it, and tests can check the schedule tables directly.

All container fields are tuples so ``ModelSpec`` is hashable.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Sequence


@dataclasses.dataclass(frozen=True)
class GNNBlockSpec:
    """One [Grapher -> FFN] pair."""

    kind: Literal["swin", "pool"]
    k: int
    dilation: int
    drop_path: float
    # swin
    window_size: tuple[int, ...] = ()
    shift_size: tuple[int, ...] = ()
    # pool
    reduce_ratio: int = 1
    pool_size: tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class StageSpec:
    features: int
    kernel_size: tuple[int, ...]
    stride: tuple[int, ...]
    n_conv: int
    img_shape: tuple[int, ...]
    gnn: tuple[GNNBlockSpec, ...] = ()
    # BasicBlockD residual blocks instead of plain conv blocks (n_conv =
    # n_blocks); used by the JAX package's ResidualEncoderUNet, not ported yet
    residual: bool = False


@dataclasses.dataclass(frozen=True)
class DecoderStageSpec:
    features: int  # = skip features
    transp_stride: tuple[int, ...]
    kernel_size: tuple[int, ...]
    n_conv: int
    img_shape: tuple[int, ...]
    gnn: tuple[GNNBlockSpec, ...] = ()


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    spatial_dims: int
    in_channels: int
    num_classes: int
    patch_size: tuple[int, ...]
    encoder: tuple[StageSpec, ...]
    decoder: tuple[DecoderStageSpec, ...]
    groups: int  # grouped-conv group count in the GNN MLPs (4 in 2D, 6 in 3D)
    act: str = "leakyrelu"
    gnn_norm: str = "instance"  # OptInit.norm
    norm_op: str = "batch"  # trainer norm_op for convs / fc / FFN
    use_bias: bool = True
    stochastic: bool = True
    epsilon: float = 0.2
    deep_supervision: bool = True
    # stride-1 stem conv block to this width before encoder stage 0
    # (ResidualEncoder's default stem); None = no stem
    stem_features: int | None = None


def _stage_shapes(
    patch_size: Sequence[int], strides: Sequence[Sequence[int]]
) -> list[tuple[int, ...]]:
    """Per-stage spatial shapes: patch integer-divided by cumulative strides
    (reference ``NexToU_Encoder_Decoder.py:70-101``; strides[0] is ignored —
    the reference walks ``strides[1:]``)."""
    shape = tuple(patch_size)
    shapes = [shape]
    for st in strides[1:]:
        shape = tuple(s // k for s, k in zip(shape, st))
        shapes.append(shape)
    return shapes


def knn_schedule(img_min_shape: Sequence[int], n_stages: int, spatial_dims: int):
    """k-list and max dilation from the bottleneck shape.

    Reference ``NexToU_Encoder_Decoder.py:960-989`` (identical in both block
    builders): ``max_num = prod(min_shape) // dims``; ``max_k`` is the member
    of [2,4,8,16,32] closest to it; ``min_k = max_num // 2**dims``;
    ``k_list = [m, 2m, 2m, 4m, 8m, (16m...)]`` clipped at ``max_k``.
    """
    v = math.prod(img_min_shape)
    max_num = v // spatial_dims  # //2 in 2D, //3 in 3D
    candidates = [2, 4, 8, 16, 32]
    max_k = min(candidates, key=lambda c: abs(c - max_num))
    # clamp >= 1: a tiny bottleneck (v < dims * 2^dims) would floor-divide to
    # min_k = 0, making every k 0 and max_dilation a ZeroDivisionError
    min_k = max(1, max_num // (2**spatial_dims))
    mults = [1, 2, 2, 4, 8]
    base = [min(min_k * m, max_k) for m in mults]
    if n_stages >= 5:
        k_list = base + [min(min_k * 16, max_k)] * (n_stages - 5)
    else:
        k_list = base[:n_stages]
    max_dilation = v // max(k_list)
    return k_list, max_dilation


def _pool_size_for(
    img_shape: Sequence[int], img_min_shape: Sequence[int]
) -> tuple[int, ...]:
    """PoolDyGraphConv's max-pool: 2 per even axis iff the map has more than
    ``4**d * prod(bottleneck)`` voxels (reference ``:490-502``)."""
    n = math.prod(img_shape)
    n_small = math.prod(h * 4 for h in img_min_shape)
    if n > n_small:
        return tuple(2 if h % 2 == 0 else 1 for h in img_shape)
    return tuple(1 for _ in img_shape)


def _dpr(drop_path_rate: float, n_blocks: int) -> list[float]:
    """Linearly-spaced stochastic-depth rates (reference ``:956``)."""
    if n_blocks == 1:
        return [0.0]
    return [drop_path_rate * i / (n_blocks - 1) for i in range(n_blocks)]


def build_model_spec(
    *,
    in_channels: int,
    patch_size: Sequence[int],
    n_stages: int,
    features_per_stage: Sequence[int],
    kernel_sizes: Sequence[Sequence[int]],
    strides: Sequence[Sequence[int]],
    n_conv_per_stage: Sequence[int],
    n_conv_per_stage_decoder: Sequence[int],
    num_classes: int,
    deep_supervision: bool = True,
    drop_path_rate: float = 0.0,
) -> ModelSpec:
    """Derive the full NexToU architecture from nnU-Net-plans-style inputs.

    Reproduces the constructor logic of ``NexToU_Encoder`` /
    ``NexToU_Decoder`` / ``{Swin,Pool}GNNBlocks``: the first ``n_stages - 4``
    stages are pure conv; the last 4 encoder stages (and the 3 deepest
    decoder stages) are Conv -> PoolGNN -> SwinGNN.
    """
    spatial_dims = len(patch_size)
    assert spatial_dims in (2, 3), patch_size
    assert len(features_per_stage) == n_stages
    assert len(kernel_sizes) == n_stages
    assert len(strides) == n_stages
    assert len(n_conv_per_stage) == n_stages
    assert len(n_conv_per_stage_decoder) == n_stages - 1
    assert n_stages >= 4, "NexToU needs >= 4 stages (4 GNN stages)"

    groups = 4 if spatial_dims == 2 else 6
    shapes = _stage_shapes(patch_size, strides)
    img_min_shape = shapes[-1]
    k_list, max_dilation = knn_schedule(img_min_shape, n_stages, spatial_dims)
    # OptInit.reduce_ratios (NexToU_Encoder_Decoder.py:32)
    reduce_ratios = [16, 8, 4, 2] + [1] * (n_stages - 4)
    # blocks = [1]*n_stages -> one [Grapher, FFN] pair per GNN group; the
    # block index used for drop-path/dilation equals the builder's `index`.
    dpr = _dpr(drop_path_rate, n_stages)
    window = tuple(img_min_shape)
    shift = tuple(w // 2 for w in window)

    no_pool_gnn_stage_num = n_stages - 4  # first GNN stage
    n_conv_stages = no_pool_gnn_stage_num  # n_swin_gnn_stages = 0 (hardcoded)

    # validate channel divisibility (README.md:64-77: why base=33/max=324)
    posembed_div = 4 if spatial_dims == 2 else 6
    for s in range(n_conv_stages, n_stages):
        f = features_per_stage[s]
        if f % groups or f % posembed_div:
            raise ValueError(
                f"GNN-stage features must be divisible by {groups} (grouped conv)"
                f" and {posembed_div} (sin-cos pos-embed); stage {s} has {f}"
            )

    def pool_block(stage_idx_in_net: int, index: int) -> GNNBlockSpec:
        # PoolGNNBlocks: k = k_list[index + stage_num] (== k_list[stage]),
        # r = reduce_ratios[index + stage_num], dilation = min(idx//4+1, maxd)
        s = index + no_pool_gnn_stage_num
        pool_size = _pool_size_for(shapes[stage_idx_in_net], img_min_shape)
        pooled = tuple(
            h // p for h, p in zip(shapes[stage_idx_in_net], pool_size)
        )
        # clamp the candidate reduction and k to what the map can supply —
        # small configs otherwise request k > #candidates, which the
        # reference would crash on too (torch.topk); the published configs
        # are unaffected (their candidate sets are always large enough).
        r = min(reduce_ratios[s], min(pooled))
        n_cand = math.prod(h // r for h in pooled) if r > 1 else math.prod(pooled)
        k = max(1, min(k_list[s], n_cand))
        return GNNBlockSpec(
            kind="pool",
            k=k,
            dilation=max(1, min(index // 4 + 1, max_dilation, n_cand // k)),
            drop_path=dpr[index],
            reduce_ratio=r,
            pool_size=pool_size,
        )

    def swin_block(index: int) -> GNNBlockSpec:
        # SwinGNNBlocks: k = k_list[index], r = 1
        n_nodes = math.prod(window)
        k = max(1, min(k_list[index], n_nodes))
        return GNNBlockSpec(
            kind="swin",
            k=k,
            dilation=max(1, min(index // 4 + 1, max_dilation, n_nodes // k)),
            drop_path=dpr[index],
            window_size=window,
            shift_size=shift,
        )

    encoder = []
    for s in range(n_stages):
        if s < n_conv_stages:
            gnn: tuple[GNNBlockSpec, ...] = ()
            n_conv = n_conv_per_stage[s]
        else:
            gnn = (
                pool_block(s, s - no_pool_gnn_stage_num),
                swin_block(s - n_conv_stages),
            )
            n_conv = n_conv_per_stage[s] - 1
        encoder.append(
            StageSpec(
                features=features_per_stage[s],
                kernel_size=tuple(kernel_sizes[s]),
                stride=tuple(strides[s]),
                n_conv=n_conv,
                img_shape=shapes[s],
                gnn=gnn,
            )
        )

    decoder = []
    for s in range(1, n_stages):
        skip_features = features_per_stage[-(s + 1)]
        stage_shape = shapes[n_stages - (s + 1)]
        if s < n_stages - no_pool_gnn_stage_num:
            gnn = (
                pool_block(
                    n_stages - (s + 1),
                    n_stages - no_pool_gnn_stage_num - (s + 1),
                ),
                swin_block(n_stages - n_conv_stages - (s + 1)),
            )
            n_conv = n_conv_per_stage_decoder[s - 1] - 1
        else:
            gnn = ()
            n_conv = n_conv_per_stage_decoder[s - 1]
        decoder.append(
            DecoderStageSpec(
                features=skip_features,
                transp_stride=tuple(strides[-s]),
                kernel_size=tuple(kernel_sizes[-(s + 1)]),
                n_conv=n_conv,
                img_shape=stage_shape,
                gnn=gnn,
            )
        )

    return ModelSpec(
        spatial_dims=spatial_dims,
        in_channels=in_channels,
        num_classes=num_classes,
        patch_size=tuple(patch_size),
        encoder=tuple(encoder),
        decoder=tuple(decoder),
        groups=groups,
        deep_supervision=deep_supervision,
    )
