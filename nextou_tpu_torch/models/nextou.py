"""The NexToU hybrid conv/GNN U-Net, counterpart of
``nextou_tpu/models/nextou.py``: an interpreter over
:class:`nextou_tpu_torch.models.spec.ModelSpec`.

Module tree and names follow upstream NexToU
(``NexToU_Encoder_Decoder.py:111-146,264-309``), so upstream state_dicts load
with ``load_state_dict`` and ``nextou_tpu.compat.torch_import`` maps this
model's ``state_dict`` onto ``nextou_tpu`` variables:

    encoder.stages.{s}.0               StackedConvBlocks (conv-only stage)
    encoder.stages.{s}.0.{0,1,2}       StackedConvBlocks, PoolGNNBlocks, SwinGNNBlocks
    decoder.stages.{s}[.{0,1,2}]       the same, one Sequential level less
    decoder.transpconvs.{s}            ConvTranspose (kernel == stride)
    decoder.seg_layers.{s}             1x1 conv

Layouts: the model takes ``(B, *patch, C_in)`` and returns channels-last
logits, like the JAX model. Inside, conv stages run channels-first (cuDNN's
layout) and GNN blocks channels-last (their 1x1 convs are matmuls over the
channel axis); a hybrid stage converts between the two once each way.

Parameters are f32; ``dtype`` is the compute dtype (bf16 on the card): the
input is cast to it, every layer casts its weights to it, norm statistics
stay f32 and logits come out in it. Every seg head is built, so checkpoints
always load; with deep supervision the outputs come highest resolution first.

Training mode (``model.train()``): batch statistics with flax's running-stat
update (``nn/layers.py::batch_norm``), f32 kNN selection, the stochastic
branches (DropPath, the stochastic dilated graph) drawing from the model's
``generator``, and optional recomputation of stages in the backward pass
(``remat``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from nextou_tpu_torch.core.pos_embed import relative_pos_bias
from nextou_tpu_torch.models.spec import GNNBlockSpec, ModelSpec
from nextou_tpu_torch.nn.conv_blocks import StackedConvBlocks, conv
from nextou_tpu_torch.nn.graphers import FFN, PoolGrapher, SwinGrapher

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_CONV_T = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_CONV_T_FN = {2: F.conv_transpose2d, 3: F.conv_transpose3d}

TableFn = Callable[[int, int, int], torch.Tensor]


class GNNBlocks(nn.Module):
    """Upstream ``{Pool,Swin}GNNBlocks`` with one [Grapher, FFN] pair:
    ``blocks.0.0`` and ``blocks.0.1``. Channels-last."""

    def __init__(self, b: GNNBlockSpec, channels: int, img_shape, spec: ModelSpec,
                 table: TableFn, generator: torch.Generator, device=None):
        super().__init__()
        common = dict(k=b.k, dilation=b.dilation, stochastic=spec.stochastic,
                      epsilon=spec.epsilon, groups=spec.groups, act_name=spec.act,
                      bias=spec.use_bias, drop_path=b.drop_path,
                      generator=generator, device=device)
        if b.kind == "pool":
            pooled = [s // p for s, p in zip(img_shape, b.pool_size)]
            n = math.prod(pooled)
            m = math.prod(s // b.reduce_ratio for s in pooled)
            grapher = PoolGrapher(
                channels, table(channels, n, m), pool_size=b.pool_size,
                reduce_ratio=b.reduce_ratio, norm=spec.gnn_norm, **common,
            )
        else:
            n = math.prod(b.window_size)
            grapher = SwinGrapher(
                channels, table(channels, n, n), window_size=b.window_size,
                shift_size=b.shift_size, **common,
            )
        ffn = FFN(channels, 4 * channels, spec.spatial_dims, act_name=spec.act,
                  drop_path=b.drop_path, generator=generator, device=device)
        self.blocks = nn.Sequential(nn.Sequential(grapher, ffn))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(x)


class HybridStage(nn.Sequential):
    """conv blocks (channels-first) -> PoolGNN -> SwinGNN (channels-last)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs, *gnn = self
        x = convs(x).movedim(1, -1)
        for blocks in gnn:
            x = blocks(x)
        return x.movedim(-1, 1).contiguous()


def _stage(n_conv, cin, cout, kernel, stride, gnn, img_shape, spec, table,
           generator, device):
    convs = StackedConvBlocks(
        n_conv, cin, cout, kernel, stride, bias=spec.use_bias, device=device
    )
    if not gnn:
        return convs
    return HybridStage(convs, *[
        GNNBlocks(b, cout, img_shape, spec, table, generator, device) for b in gnn
    ])


_REMAT_BIG_BYTES = 64 * 1024 * 1024  # bf16 bytes per batch element


def remat_flags(spec: ModelSpec, mode) -> tuple[list[bool], list[bool]]:
    """Which encoder and decoder stages are recomputed in the backward pass,
    for ``mode`` in {False, True, 'big'} (``_remat_flags`` in the JAX
    package): 'big' takes the stages whose output feature map, in bf16, is at
    least 64 MiB per batch element."""
    n_e, n_d = len(spec.encoder), len(spec.decoder)
    if mode is True:
        return [True] * n_e, [True] * n_d
    if not mode:
        return [False] * n_e, [False] * n_d
    if mode != "big":
        raise ValueError(f"remat must be False, True or 'big'; got {mode!r}")
    shape = list(spec.patch_size)
    enc_bytes = []
    for st in spec.encoder:
        shape = [a // b for a, b in zip(shape, st.stride)]
        enc_bytes.append(math.prod(shape) * st.features * 2)
    enc = [b >= _REMAT_BIG_BYTES for b in enc_bytes]
    # decoder stage i computes at encoder stage n_e-2-i's resolution and width
    dec = [enc_bytes[n_e - 2 - i] >= _REMAT_BIG_BYTES for i in range(n_d)]
    return enc, dec


def _recomputed(fn, modules, generator: torch.Generator, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint``: its activations are
    dropped and ``fn`` runs again in the backward pass. The second run must
    repeat the first: it draws the same random numbers (the generator is set
    back to where the first run found it, then put forward again), and it
    leaves the BatchNorm running statistics alone (momentum 0 while it runs),
    which the first run has updated already."""
    norms = [
        m for mod in modules for m in mod.modules()
        if isinstance(m, nn.modules.batchnorm._BatchNorm)
    ]
    start = generator.get_state()
    first = True

    def run(*a):
        nonlocal first
        if first:
            first = False
            return fn(*a)
        now = generator.get_state()
        momenta = [m.momentum for m in norms]
        generator.set_state(start)
        for m in norms:
            m.momentum = 0.0
        try:
            return fn(*a)
        finally:
            for m, mom in zip(norms, momenta):
                m.momentum = mom
            generator.set_state(now)

    return checkpoint(run, *args, use_reentrant=False)


class Encoder(nn.Module):
    def __init__(self, spec: ModelSpec, table: TableFn, generator, device=None):
        super().__init__()
        stages, cin = [], spec.in_channels
        for st in spec.encoder:
            if st.residual:
                raise NotImplementedError("residual encoder stages are not ported yet")
            stages.append(nn.Sequential(_stage(
                st.n_conv, cin, st.features, st.kernel_size, st.stride, st.gnn,
                st.img_shape, spec, table, generator, device,
            )))
            cin = st.features
        self.stages = nn.ModuleList(stages)
        self.generator = generator

    def forward(self, x: torch.Tensor, remat: list[bool]) -> list[torch.Tensor]:
        skips = []
        for stage, again in zip(self.stages, remat):
            if again and torch.is_grad_enabled():
                x = _recomputed(stage, [stage], self.generator, x)
            else:
                x = stage(x)
            skips.append(x)
        return skips


class Decoder(nn.Module):
    def __init__(self, spec: ModelSpec, table: TableFn, generator, device=None):
        super().__init__()
        d = spec.spatial_dims
        stages, transp, heads = [], [], []
        cin = spec.encoder[-1].features
        for st in spec.decoder:
            transp.append(_CONV_T[d](
                cin, st.features, st.transp_stride, st.transp_stride,
                bias=spec.use_bias, device=device,
            ))
            stages.append(_stage(
                st.n_conv, 2 * st.features, st.features, st.kernel_size,
                (1,) * d, st.gnn, st.img_shape, spec, table, generator, device,
            ))
            heads.append(_CONV[d](st.features, spec.num_classes, 1, device=device))
            cin = st.features
        self.stages = nn.ModuleList(stages)
        self.transpconvs = nn.ModuleList(transp)
        self.seg_layers = nn.ModuleList(heads)
        self.deep_supervision = spec.deep_supervision
        self.generator = generator

    def forward(self, skips: list[torch.Tensor], remat: list[bool]) -> list[torch.Tensor]:
        x = skips[-1]
        n = len(self.stages)
        outs = []
        for i, (stage, up, head) in enumerate(
            zip(self.stages, self.transpconvs, self.seg_layers)
        ):
            def run(x, skip, stage=stage, up=up):
                b = None if up.bias is None else up.bias.to(x.dtype)
                x = _CONV_T_FN[x.dim() - 2](x, up.weight.to(x.dtype), b, up.stride)
                return stage(torch.cat([x, skip], dim=1))

            if remat[i] and torch.is_grad_enabled():
                x = _recomputed(run, [stage], self.generator, x, skips[-(i + 2)])
            else:
                x = run(x, skips[-(i + 2)])
            if self.deep_supervision or i == n - 1:
                outs.append(conv(x, head))
        return outs[::-1]  # highest resolution first


class NexToU(nn.Module):
    """The full network.

    ``forward(x)`` takes ``(B, *patch, C_in)`` and returns channels-last
    logits in ``dtype``: a list [full-res, ..., lowest-res] when
    ``spec.deep_supervision``, else the full-res array.

    Parameters are created on ``device``. Each relative-position table is
    built once (host numpy, see ``core/pos_embed.py``) and the same device
    tensor is registered in every grapher that uses it; ``load_state_dict``
    copies in place and keeps that sharing, ``.to()`` would give each
    grapher its own copy.

    ``remat`` in {False, True, 'big'} recomputes no stage, every stage, or
    the large ones (:func:`remat_flags`) in the backward pass instead of
    keeping their activations. ``generator`` (CPU) feeds DropPath and the
    stochastic dilated graphs in training mode.
    """

    def __init__(self, spec: ModelSpec, *, dtype: torch.dtype = torch.float32,
                 remat=False, device=None):
        super().__init__()
        if spec.stem_features is not None:
            raise NotImplementedError("the residual encoder stem is not ported yet")
        self.spec = spec
        self.dtype = dtype
        self.remat = remat_flags(spec, remat)
        self.generator = torch.Generator()
        tables: dict[tuple[int, int, int], torch.Tensor] = {}

        def table(channels: int, n: int, m: int) -> torch.Tensor:
            key = (channels, n, m)
            if key not in tables:
                rel = relative_pos_bias(channels, n, m, spec.spatial_dims)
                tables[key] = torch.tensor(rel, device=device)[None]
            return tables[key]

        self.encoder = Encoder(spec, table, self.generator, device)
        self.decoder = Decoder(spec, table, self.generator, device)

    def forward(self, x: torch.Tensor):
        s = self.spec
        if tuple(x.shape[1:-1]) != tuple(s.patch_size):
            raise ValueError(f"input spatial {tuple(x.shape[1:-1])} != patch {s.patch_size}")
        x = x.to(self.dtype).movedim(-1, 1).contiguous()
        enc_remat, dec_remat = self.remat
        skips = self.encoder(x, enc_remat)
        outs = [o.movedim(1, -1) for o in self.decoder(skips, dec_remat)]
        return outs if s.deep_supervision else outs[0]
