"""Operations of one NexToU forward, counted from the network's spec alone.

Counted, at two operations per multiply-add: every conv (the stride-1 and
strided convs of the conv stages, the transposed convs, the seg heads), the
graphers' 1x1 matmuls (fc1, the grouped MLP of the max-relative conv at its
group count, fc2), the FFNs' two matmuls, and the kNN distance product
(queries x candidates x channels). Norms, activations, pooling, the
selection and the losses are not counted. A train step is counted as three
forwards (forward, and the backward's two products per layer), with no
recomputation.
"""

from __future__ import annotations

import math


def _conv(cin, cout, kernel, out_shape) -> float:
    return 2.0 * cin * cout * math.prod(kernel) * math.prod(out_shape)


def _gnn(b, c: int, shape, groups: int) -> float:
    n = math.prod(shape)
    total = 2.0 * c * c * n + 2.0 * (2 * c) * c * n  # fc1, fc2 over the whole map
    if b.kind == "pool":
        pooled = [s // p for s, p in zip(shape, b.pool_size)]
        nodes = math.prod(pooled)
        cand = math.prod(s // b.reduce_ratio for s in pooled)
        total += 2.0 * nodes * cand * c  # distance product
    else:
        nodes = n
        total += 2.0 * n * math.prod(b.window_size) * c
    total += 2.0 * nodes * (2 * c) * (2 * c) / groups  # grouped MLP
    total += 2 * 2.0 * c * (4 * c) * n  # FFN
    return total


def forward_flops(spec, deep_supervision: bool | None = None) -> float:
    """Operations of one sample's forward; the seg heads of every decoder
    stage with deep supervision, else the last one only."""
    ds = spec.deep_supervision if deep_supervision is None else deep_supervision
    total, cin = 0.0, spec.in_channels
    for st in spec.encoder:
        for i in range(st.n_conv):
            total += _conv(cin if i == 0 else st.features, st.features, st.kernel_size,
                           st.img_shape)
        for b in st.gnn:
            total += _gnn(b, st.features, st.img_shape, spec.groups)
        cin = st.features
    for i, st in enumerate(spec.decoder):
        # transposed conv, kernel = stride: one multiply-add per input and output channel
        # at every output voxel
        total += 2.0 * cin * st.features * math.prod(st.img_shape)
        for j in range(st.n_conv):
            total += _conv(2 * st.features if j == 0 else st.features, st.features,
                           st.kernel_size, st.img_shape)
        for b in st.gnn:
            total += _gnn(b, st.features, st.img_shape, spec.groups)
        if ds or i == len(spec.decoder) - 1:
            total += _conv(st.features, spec.num_classes, (1,), st.img_shape)
        cin = st.features
    return total


def train_step_flops(spec, batch: int) -> float:
    return 3.0 * batch * forward_flops(spec, deep_supervision=True)
