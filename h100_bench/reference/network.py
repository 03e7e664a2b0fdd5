"""The plain NexToU network the benchmark holds the port against: float32,
plain PyTorch operations only, no kernels, cache or fused paths.

It follows the published description (upstream
``NexToU_Encoder_Decoder.py``): conv stages (conv, BatchNorm, LeakyReLU
0.01), and in the last four encoder and three deepest decoder stages a
pooled grapher (max pool, kNN graph over all nodes against average-pooled
candidates, max-relative graph conv, scatter back to the argmax) and a
windowed grapher (roll, window partition, kNN graph inside each window),
each followed by an FFN. kNN is ``topk`` over squared L2 distances of the
L2-normalized features plus the relative-position bias; the max-relative
conv interleaves ``[x, max_j x_j - x]``. Parameters carry upstream's names,
so one weights dict loads into this network and into the port's.

``Precision`` rounds the operands and the outputs of every conv and matmul
and the operands of the distance product, as a network that computes and
stores in a lower precision does: ``"f32"`` leaves them, ``"fp8"`` rounds
them per tensor to float8 e4m3 and their gradients to e5m2, as fp8
training does (the precision below the configuration's bf16: the control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from h100_bench.reference.posembed import relative_pos_bias
from h100_bench.reference.spec import ModelSpec

SLOPE = 1e-2
EPS = 1e-5


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded per tensor to ``dtype``, scaled so that its largest
    magnitude is the format's largest value, and back to float32."""
    top = torch.finfo(dtype).max
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """Values in e4m3, their gradients in e5m2: fp8 training's formats."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(name)
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "f32" else _Fp8.apply(x)


# --- parameter holders with upstream's names --------------------------------------


class Conv(nn.Module):
    def __init__(self, cin, cout, kernel, stride, transposed=False, bias=True, groups=1):
        super().__init__()
        shape = (cin, cout, *kernel) if transposed else (cout, cin // groups, *kernel)
        self.weight = nn.Parameter(torch.zeros(shape))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.kernel, self.transposed = tuple(stride), tuple(kernel), transposed
        self.groups = groups


class Norm(nn.Module):
    """Scale and shift; a BatchNorm also holds its running statistics."""

    def __init__(self, c, running=True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        if running:
            self.register_buffer("running_mean", torch.zeros(c))
            self.register_buffer("running_var", torch.ones(c))


def batch_norm(x: torch.Tensor, norm: Norm, axis: int, ctx) -> torch.Tensor:
    """BatchNorm over every axis but ``axis``: batch statistics in training
    (kept as the running ones where ``ctx.calibrate``), else the running
    statistics."""
    axis = axis % x.dim()
    shape = [1] * x.dim()
    shape[axis] = -1
    if ctx.training:
        dims = [d for d in range(x.dim()) if d != axis]
        mean = x.mean(dims, keepdim=True)
        var = (x - mean).square().mean(dims, keepdim=True)
        if ctx.calibrate:
            norm.running_mean.copy_(mean.detach().reshape(-1))
            norm.running_var.copy_(var.detach().reshape(-1))
    else:
        mean, var = norm.running_mean.view(shape), norm.running_var.view(shape)
    y = (x - mean) / torch.sqrt(var + EPS)
    return y * norm.weight.view(shape) + norm.bias.view(shape)


def instance_norm(x: torch.Tensor, norm: Norm) -> torch.Tensor:
    """Per sample and channel over the nodes of ``(B, N, C)``."""
    mean = x.mean(1, keepdim=True)
    var = (x - mean).square().mean(1, keepdim=True)
    return (x - mean) / torch.sqrt(var + EPS) * norm.weight + norm.bias


def leaky(x):
    return F.leaky_relu(x, SLOPE)


# --- blocks ------------------------------------------------------------------------


class ConvNormAct(nn.Module):
    def __init__(self, cin, cout, kernel, stride):
        super().__init__()
        self.conv = Conv(cin, cout, kernel, stride)
        self.norm = Norm(cout)

    def forward(self, x, ctx):
        c = self.conv
        pad = tuple((k - 1) // 2 for k in c.kernel)
        fn = F.conv3d if x.dim() == 5 else F.conv2d
        y = ctx.prec(fn(ctx.prec(x), ctx.prec(c.weight), c.bias, c.stride, pad))
        return leaky(batch_norm(y, self.norm, 1, ctx))


class StackedConvBlocks(nn.Module):
    def __init__(self, n, cin, cout, kernel, stride):
        super().__init__()
        ones = (1,) * len(kernel)
        self.convs = nn.Sequential(*[
            ConvNormAct(cin if i == 0 else cout, cout, kernel, stride if i == 0 else ones)
            for i in range(n)])

    def forward(self, x, ctx):
        for block in self.convs:
            x = block(x, ctx)
        return x


class Fc(nn.Sequential):
    """1x1 conv (``0``) and BatchNorm (``1``) over the last axis."""

    def __init__(self, cin, cout, dims):
        super().__init__(Conv(cin, cout, (1,) * dims, (1,) * dims), Norm(cout))

    def forward(self, x, ctx):
        conv, norm = self[0], self[1]
        w = conv.weight.reshape(conv.weight.shape[0], -1)
        return batch_norm(ctx.prec(F.linear(ctx.prec(x), ctx.prec(w), conv.bias)), norm, -1, ctx)


def grouped_linear(x, conv: Conv, ctx):
    """A grouped 1x1 conv over the last axis: one matmul per group."""
    g = conv.groups
    cout, cin_g = conv.weight.shape[:2]
    w = conv.weight.reshape(g, cout // g, cin_g)
    xs = x.reshape(*x.shape[:-1], g, cin_g)
    y = torch.einsum("...gi,goi->...go", ctx.prec(xs), ctx.prec(w))
    return ctx.prec(y.reshape(*x.shape[:-1], cout) + conv.bias)


def unit_rows(x):
    """``x / sqrt(max(|x|^2, 1e-24))`` over the last axis."""
    return x / torch.sqrt(torch.clamp(x.square().sum(-1, keepdim=True), min=1e-24))


def knn_max(x, y, rel, k, ctx):
    """Per-channel max of the raw candidate values ``y (B, M, C)`` over the k
    nearest candidates of each query ``x (B, N, C)``: L2-normalized features,
    squared distances plus the bias ``rel (N, M)``, ``topk``."""
    xn, yn = unit_rows(x), unit_rows(y)
    xq, yq = ctx.prec(xn), ctx.prec(yn)
    dist = (xq.square().sum(-1, keepdim=True) - 2.0 * torch.bmm(xq, yq.transpose(1, 2))
            + yq.square().sum(-1).unsqueeze(1))
    idx = torch.topk((dist + rel).detach(), k, dim=-1, largest=False).indices  # (B, N, k)
    B, N, _ = idx.shape
    rows = torch.gather(y, 1, idx.reshape(B, N * k, 1).expand(B, N * k, y.shape[-1]))
    return rows.reshape(B, N, k, -1).amax(2)


class GraphConv(nn.Module):
    """``graph_conv``: kNN, max-relative aggregation, grouped MLP ``gconv.nn``."""

    def __init__(self, c, groups, norm_kind, dims):
        super().__init__()
        ones = (1,) * dims
        self.gconv = nn.Module()
        self.gconv.nn = nn.Sequential(Conv(2 * c, 2 * c, ones, ones, groups=groups),
                                      Norm(2 * c, running=norm_kind == "batch"))
        self.norm_kind = norm_kind

    def forward(self, nodes, cand, rel, k, ctx):
        m = knn_max(nodes, cand, rel, k, ctx)
        B, N, C = nodes.shape
        h = torch.stack([nodes, m - nodes], -1).reshape(B, N, 2 * C)
        conv, norm = self.gconv.nn[0], self.gconv.nn[1]
        h = grouped_linear(h, conv, ctx)
        if self.norm_kind == "instance":
            h = instance_norm(h, norm)
        else:
            h = batch_norm(h, norm, -1, ctx)
        return leaky(h)


def avg_pool_nodes(x, r):
    """Channels-last average pool, kernel = stride = r, floor: the window's
    sum over its r^d voxels."""
    sp = x.shape[1:-1]
    out = [s // r for s in sp]
    x = x[(slice(None), *[slice(0, o * r) for o in out])]
    shape = [x.shape[0]]
    for o in out:
        shape += [o, r]
    win = x.reshape(*shape, x.shape[-1])
    return win.sum(dim=tuple(2 + 2 * i for i in range(len(sp)))) / float(r ** len(sp))


_TABLES: dict = {}


def rel_table(key, device) -> torch.Tensor:
    """The relative-position bias ``(n, m)`` on ``device``, built once."""
    if (key, str(device)) not in _TABLES:
        _TABLES[(key, str(device))] = relative_pos_bias(*key, device=device)
    return _TABLES[(key, str(device))]


class SwinGrapher(nn.Module):
    def __init__(self, c, b, spec):
        super().__init__()
        dims = spec.spatial_dims
        self.fc1, self.fc2 = Fc(c, c, dims), Fc(2 * c, c, dims)
        self.graph_conv = GraphConv(c, spec.groups, "batch", dims)
        self.b = b
        n = math.prod(b.window_size)
        self.table = (c, n, n, dims)

    def forward(self, x, ctx):
        b = self.b
        sp, C = x.shape[1:-1], x.shape[-1]
        axes = tuple(range(1, 1 + len(sp)))
        h = torch.roll(x, [-s for s in b.shift_size], axes) if max(b.shift_size) > 0 else x
        # window partition: (B, *sp, C) -> (B * windows, prod(window), C)
        shape = [x.shape[0]]
        for s, w in zip(sp, b.window_size):
            shape += [s // w, w]
        nd = len(sp)
        perm = [0] + [1 + 2 * i for i in range(nd)] + [2 + 2 * i for i in range(nd)] + [1 + 2 * nd]
        win = h.reshape(*shape, C).permute(perm)
        grid = win.shape[1:1 + nd]
        win = win.reshape(-1, math.prod(b.window_size), C)
        nodes = self.fc1(win, ctx)
        h = self.fc2(self.graph_conv(nodes, nodes, rel_table(self.table, x.device), b.k, ctx), ctx)
        inv = [0]
        for i in range(nd):
            inv += [1 + i, 1 + nd + i]
        inv.append(1 + 2 * nd)
        h = h.reshape(x.shape[0], *grid, *b.window_size, C).permute(inv).reshape(x.shape)
        if max(b.shift_size) > 0:
            h = torch.roll(h, list(b.shift_size), axes)
        return h + x


class PoolGrapher(nn.Module):
    def __init__(self, c, b, img_shape, spec):
        super().__init__()
        dims = spec.spatial_dims
        self.fc1, self.fc2 = Fc(c, c, dims), Fc(2 * c, c, dims)
        self.graph_conv = GraphConv(c, spec.groups, spec.gnn_norm, dims)
        self.b = b
        pooled = [s // p for s, p in zip(img_shape, b.pool_size)]
        n, m = math.prod(pooled), math.prod(s // b.reduce_ratio for s in pooled)
        self.table = (c, n, m, dims)

    def forward(self, x, ctx):
        b = self.b
        h = self.fc1(x, ctx).movedim(-1, 1)  # channels first for the pooling
        d = h.dim() - 2
        pool = (F.max_pool3d if d == 3 else F.max_pool2d)
        unpool = (F.max_unpool3d if d == 3 else F.max_unpool2d)
        pooled, arg = pool(h, b.pool_size, b.pool_size, return_indices=True)
        nodes_map = pooled.movedim(1, -1)
        B, C = nodes_map.shape[0], nodes_map.shape[-1]
        nodes = nodes_map.reshape(B, -1, C)
        cand = nodes
        if b.reduce_ratio > 1:
            cand = avg_pool_nodes(nodes_map, b.reduce_ratio).reshape(B, -1, C)
        out = self.graph_conv(nodes, cand, rel_table(self.table, x.device), b.k, ctx)  # (B, N, 2C)
        out = out.reshape(*nodes_map.shape[:-1], 2 * C).movedim(-1, 1)
        # the channel-doubled output goes back to the argmax of its channel mod C
        up = unpool(out, torch.cat([arg, arg], 1), b.pool_size, b.pool_size,
                    output_size=h.shape[2:])
        return self.fc2(up.movedim(1, -1), ctx) + x


class FFN(nn.Module):
    def __init__(self, c, dims):
        super().__init__()
        self.fc1, self.fc2 = Fc(c, 4 * c, dims), Fc(4 * c, c, dims)

    def forward(self, x, ctx):
        return self.fc2(leaky(self.fc1(x, ctx)), ctx) + x


class GNNBlocks(nn.Module):
    def __init__(self, b, c, img_shape, spec):
        super().__init__()
        grapher = (PoolGrapher(c, b, img_shape, spec) if b.kind == "pool"
                   else SwinGrapher(c, b, spec))
        self.blocks = nn.Sequential(nn.Sequential(grapher, FFN(c, spec.spatial_dims)))

    def forward(self, x, ctx):
        grapher, ffn = self.blocks[0]
        return ffn(grapher(x, ctx), ctx)


class Stage(nn.Sequential):
    """Conv blocks, then (hybrid stages) the two GNN blocks channels-last."""

    def forward(self, x, ctx):
        x = self[0](x, ctx)
        if len(self) == 1:
            return x
        x = x.movedim(1, -1)
        for blocks in list(self)[1:]:
            x = blocks(x, ctx)
        return x.movedim(-1, 1)


def _stage(n_conv, cin, cout, kernel, stride, gnn, img_shape, spec):
    convs = StackedConvBlocks(n_conv, cin, cout, kernel, stride)
    if not gnn:
        return convs
    return Stage(convs, *[GNNBlocks(b, cout, img_shape, spec) for b in gnn])


class _Ctx:
    def __init__(self, prec, training, calibrate=False):
        self.prec, self.training, self.calibrate = prec, training, calibrate


class NexToU(nn.Module):
    """``forward(x (B, *patch, C_in))`` -> channels-last logits: the list of
    deep-supervision outputs, highest resolution first, or the full-resolution
    one. ``training`` picks batch statistics; ``calibrate`` (with it) keeps
    them as every BatchNorm's running statistics."""

    def __init__(self, spec: ModelSpec, precision: str = "f32"):
        super().__init__()
        self.spec = spec
        self.prec = Precision(precision)
        d = spec.spatial_dims
        self.encoder = nn.Module()
        stages, cin = [], spec.in_channels
        for st in spec.encoder:
            stages.append(nn.Sequential(_stage(st.n_conv, cin, st.features, st.kernel_size,
                                               st.stride, st.gnn, st.img_shape, spec)))
            cin = st.features
        self.encoder.stages = nn.ModuleList(stages)
        self.decoder = nn.Module()
        dstages, transp, heads = [], [], []
        for st in spec.decoder:
            transp.append(Conv(cin, st.features, st.transp_stride, st.transp_stride,
                               transposed=True))
            dstages.append(_stage(st.n_conv, 2 * st.features, st.features, st.kernel_size,
                                  (1,) * d, st.gnn, st.img_shape, spec))
            heads.append(Conv(st.features, spec.num_classes, (1,) * d, (1,) * d))
            cin = st.features
        self.decoder.stages = nn.ModuleList(dstages)
        self.decoder.transpconvs = nn.ModuleList(transp)
        self.decoder.seg_layers = nn.ModuleList(heads)

    def forward(self, x: torch.Tensor, training: bool = False, calibrate: bool = False):
        ctx = _Ctx(self.prec, training, calibrate)
        spec, d = self.spec, self.spec.spatial_dims
        conv_t = F.conv_transpose3d if d == 3 else F.conv_transpose2d
        conv = F.conv3d if d == 3 else F.conv2d
        x = x.float().movedim(-1, 1)
        skips = []
        for stage in self.encoder.stages:
            x = stage[0](x, ctx)
            skips.append(x)
        outs = []
        n = len(self.decoder.stages)
        for i, (stage, up, head) in enumerate(zip(
                self.decoder.stages, self.decoder.transpconvs, self.decoder.seg_layers)):
            x = ctx.prec(conv_t(ctx.prec(x), ctx.prec(up.weight), up.bias, up.stride))
            x = stage(torch.cat([x, skips[-(i + 2)]], 1), ctx)
            if spec.deep_supervision or i == n - 1:
                outs.append(ctx.prec(conv(ctx.prec(x), ctx.prec(head.weight), head.bias))
                            .movedim(1, -1))
        outs = outs[::-1]
        return outs if spec.deep_supervision else outs[0]
