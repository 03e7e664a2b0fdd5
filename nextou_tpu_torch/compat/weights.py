"""``nextou_tpu`` variables -> this port's ``state_dict``.

The inverse of ``nextou_tpu/compat/torch_import.py::torch_state_dict_to_variables``:
:func:`variables_to_state_dict` takes the JAX package's
``{'params', 'batch_stats', 'constants'}`` tree (arrays of any kind numpy can
read) and returns a ``state_dict`` under upstream NexToU's names, for
``NexToU.load_state_dict``. The per-block helpers do the same for one conv
stack, grapher or FFN. Layout transforms:

- Conv: flax ``(*k, I, O)`` -> torch ``(O, I, *k)``;
- ConvTranspose: flax ``(*k, I, O)`` with spatial axes reversed -> torch
  ``(I, O, *k)`` (torch's kernel is the spatially flipped flax one);
- Dense ``(I, O)`` -> 1x1 conv ``(O, I, *1)``;
- GroupedDense ``(g, I/g, O/g)`` -> grouped 1x1 conv ``(O, I/g, *1)``;
- norms: scale/bias -> weight/bias, mean/var -> running_mean/running_var;
- relative-position constants ``(N, M)`` -> ``relative_pos`` ``(1, N, M)``;
- PReLU ``alpha`` -> ``weight`` (``ffn.act``, ``graph_conv.gconv.nn.2``).

Names beyond NexToU's, for the plain and residual U-Nets (the JAX package's
residual classes have no upstream parity test; these names are the port's
and are held equal to the JAX package by its tests):

- ``stem/{conv,norm}`` -> ``encoder.stem.convs.0.{conv,norm}``;
- a residual encoder stage's ``enc_{s}/convs/block_{b}/{conv1,norm1,conv2,
  norm2,skip_conv,skip_norm}`` -> ``encoder.stages.{s}.0.blocks.{b}.{conv1.conv,
  conv1.norm,conv2.conv,conv2.norm,skip.conv,skip.norm}``.

``lenient=True`` maps what a tree holds and leaves out what it lacks (a
checkpoint of another architecture, for ``-pretrained_weights``).

:func:`load_train_state` carries a whole ``nextou_tpu`` ``TrainState`` over:
the momentum tree of its optimizer has the parameters' structure, so the
same mapping serves it.

:func:`extract_network_weights` reads an upstream checkpoint's
``state_dict`` the way ``nextou_tpu/compat/torch_import.py`` does.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from nextou_tpu_torch.models.spec import ModelSpec


class _Absent(dict):
    """A subtree a lenient lookup did not find: every lookup in it is absent
    too, and every leaf made from it is ``None``."""

    def __getitem__(self, key):
        return self


_ABSENT = _Absent()


class _Lenient(dict):
    """A variable tree whose missing entries read as :data:`_ABSENT`."""

    def __getitem__(self, key):
        if key not in self:
            return _ABSENT
        v = dict.__getitem__(self, key)
        return _Lenient(v) if isinstance(v, dict) else v


def _leaf(fn):
    """A layout transform that passes an absent leaf through."""
    return lambda a, *args: a if a is _ABSENT else fn(np.asarray(a), *args)


def _t(a) -> torch.Tensor | None:
    return None if a is _ABSENT else torch.from_numpy(np.array(a, dtype=np.float32))


@_leaf
def _conv_w(w) -> np.ndarray:
    nd = w.ndim - 2
    return np.transpose(w, (nd + 1, nd, *range(nd)))


@_leaf
def _transp_w(w) -> np.ndarray:
    nd = w.ndim - 2
    return np.transpose(w[(slice(None, None, -1),) * nd], (nd, nd + 1, *range(nd)))


@_leaf
def _dense_w(w, dims: int) -> np.ndarray:
    """Dense ``(I, O)`` -> 1x1 conv ``(O, I, *1)``."""
    return w.T.reshape(*w.T.shape, *([1] * dims))


@_leaf
def _grouped_w(w, dims: int) -> np.ndarray:
    """GroupedDense ``(g, I/g, O/g)`` -> grouped 1x1 conv ``(O, I/g, *1)``."""
    g, ci, co = w.shape
    return np.transpose(w, (0, 2, 1)).reshape(g * co, ci, *([1] * dims))


def _norm(ref: str, p, s) -> dict:
    sd = {ref + ".weight": _t(p["scale"]), ref + ".bias": _t(p["bias"])}
    if s is not None:
        sd[ref + ".running_mean"] = _t(s["mean"])
        sd[ref + ".running_var"] = _t(s["var"])
        sd[ref + ".num_batches_tracked"] = torch.tensor(0)
    return sd


def _fc(ref: str, p, s, dims: int) -> dict:
    return {
        ref + ".0.weight": _t(_dense_w(p["dense"]["kernel"], dims)),
        ref + ".0.bias": _t(p["dense"]["bias"]),
        **_norm(ref + ".1", p["norm"], s["norm"]),
    }


def _prelu(ref: str, act) -> dict:
    """An ``ActLayer``'s PReLU slopes, where it has them."""
    return {ref + ".weight": _t(act["PReLU_0"]["alpha"])} if "PReLU_0" in act else {}


def _conv_norm(ref: str, conv, norm, norm_stats) -> dict:
    sd = {ref + ".conv.weight": _t(_conv_w(conv["kernel"]))}
    if "bias" in conv:
        sd[ref + ".conv.bias"] = _t(conv["bias"])
    return {**sd, **_norm(ref + ".norm", norm, norm_stats)}


def conv_blocks_state(params, stats) -> dict:
    """A ``StackedConvBlocks``' variables -> ``convs.{j}.conv/.norm``."""
    sd = {}
    for j in range(len(params)):
        p, s = params[f"block_{j}"], stats[f"block_{j}"]
        sd.update(_conv_norm(f"convs.{j}", p["conv"], p["norm"], s["norm"]))
    return sd


def residual_blocks_state(params, stats) -> dict:
    """A ``StackedResidualBlocks``' variables -> ``blocks.{b}.conv1/.conv2/
    .skip``, each ``.conv`` and ``.norm``."""
    sd = {}
    for b in range(len(params)):
        p, s = params[f"block_{b}"], stats[f"block_{b}"]
        for ours, conv, norm in (("conv1", "conv1", "norm1"), ("conv2", "conv2", "norm2"),
                                 ("skip", "skip_conv", "skip_norm")):
            if conv in p:
                sd.update(_conv_norm(f"blocks.{b}.{ours}", p[conv], p[norm], s[norm]))
    return sd


def grapher_state(params, stats, constants, *, graph_norm: str, dims: int) -> dict:
    """A grapher's variables -> ``fc1``, ``graph_conv.gconv.nn``, ``fc2`` and,
    where it has one, ``relative_pos``. ``graph_norm`` is its graph conv's
    norm."""
    pn = params["graph_conv"]["gconv"]["nn"]
    sn = stats["graph_conv"]["gconv"]["nn"]["norm_0"] if graph_norm == "batch" else None
    sd = {
        **_fc("fc1", params["fc1"], stats["fc1"], dims),
        "graph_conv.gconv.nn.0.weight": _t(_grouped_w(pn["dense_0"]["kernel"], dims)),
        "graph_conv.gconv.nn.0.bias": _t(pn["dense_0"]["bias"]),
        **_norm("graph_conv.gconv.nn.1", pn["norm_0"], sn),
        **_prelu("graph_conv.gconv.nn.2", pn.get("act_0", {})),
        **_fc("fc2", params["fc2"], stats["fc2"], dims),
    }
    for table in constants.values():  # one table, or none without a position bias
        sd["relative_pos"] = _t(table)[None]
    return sd


def ffn_state(params, stats, dims: int) -> dict:
    return {
        **_fc("fc1", params["fc1"], stats["fc1"], dims),
        **_prelu("act", params.get("act", {})),
        **_fc("fc2", params["fc2"], stats["fc2"], dims),
    }


def variables_to_state_dict(variables, spec: ModelSpec, *,
                            lenient: bool = False) -> dict[str, torch.Tensor]:
    """Map ``nextou_tpu`` variables of the network ``spec`` describes (NexToU,
    PlainConvUNet or ResidualEncoderUNet) onto this port's ``state_dict``.
    With ``lenient`` what the tree lacks is left out instead of raising."""
    if lenient:
        variables = _Lenient(variables)
    params, stats = variables["params"], variables["batch_stats"]
    consts = variables["constants"] if "constants" in variables else {}
    dims = spec.spatial_dims
    sd: dict[str, torch.Tensor] = {}

    def put(prefix: str, part: dict):
        sd.update({f"{prefix}.{k}": v for k, v in part.items()})

    if spec.stem_features is not None:
        put("encoder.stem", conv_blocks_state({"block_0": params["stem"]},
                                              {"block_0": stats["stem"]}))

    def stage(our: str, base: str, st):
        conv_ref = base + ".0" if st.gnn else base
        blocks = residual_blocks_state if getattr(st, "residual", False) else conv_blocks_state
        put(conv_ref, blocks(params[our]["convs"], stats[our]["convs"]))
        for i, b in enumerate(st.gnn):
            ref = f"{base}.{1 + i}.blocks.0"
            graph_norm = "batch" if b.kind == "swin" else spec.gnn_norm
            put(ref + ".0", grapher_state(
                params[our]["gnn"][f"grapher_{i}"], stats[our]["gnn"][f"grapher_{i}"],
                consts[our]["gnn"][f"grapher_{i}"], graph_norm=graph_norm, dims=dims,
            ))
            put(ref + ".1", ffn_state(
                params[our]["gnn"][f"ffn_{i}"], stats[our]["gnn"][f"ffn_{i}"], dims
            ))

    for s, st in enumerate(spec.encoder):
        stage(f"enc_{s}", f"encoder.stages.{s}.0", st)
    for s, st in enumerate(spec.decoder):
        stage(f"dec_{s}", f"decoder.stages.{s}", st)
        tp, head = params[f"dec_{s}"]["transpconv"], params[f"seg_head_{s}"]
        sd[f"decoder.transpconvs.{s}.weight"] = _t(_transp_w(tp["kernel"]))
        sd[f"decoder.transpconvs.{s}.bias"] = _t(tp["bias"])
        sd[f"decoder.seg_layers.{s}.weight"] = _t(_conv_w(head["kernel"]))
        sd[f"decoder.seg_layers.{s}.bias"] = _t(head["bias"])
    return {k: v for k, v in sd.items() if v is not None}


def load_train_state(state, variables, momentum, step: int, spec: ModelSpec) -> None:
    """Load a ``nextou_tpu`` train state into the port's ``TrainState`` in
    place, so that both take the same next step.

    ``variables`` is the ``{'params', 'batch_stats', 'constants'}`` tree,
    ``momentum`` the trace of the optimizer (a tree shaped like ``params``),
    ``step`` the number of updates made. The generator's state is the port's
    own and stays as it is.
    """
    as_params = {**variables, "params": momentum}
    names = {name for name, _ in state.model.named_parameters()}
    moment = {
        k: v for k, v in variables_to_state_dict(as_params, spec).items() if k in names
    }
    state.load_state_dict({
        "model": variables_to_state_dict(variables, spec),
        "momentum": moment,
        "step": step,
        "generator": state.model.generator.get_state(),
    })


def extract_network_weights(ckpt) -> dict:
    """The network ``state_dict`` of an nnU-Net checkpoint dict (key
    ``'network_weights'``) or of a raw ``state_dict``, under this port's
    names: DDP's ``module.`` and ``torch.compile``'s ``_orig_mod.`` prefixes
    are stripped, and two kinds of alias are dropped: the ``all_modules.N``
    entries ``dynamic_network_architectures`` registers beside each
    conv/norm/nonlin, and ``decoder.encoder.*``, the second copy of the
    encoder a decoder holding a reference to it registers."""
    sd = ckpt.get("network_weights", ckpt) if isinstance(ckpt, dict) else ckpt
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^(module\.|_orig_mod\.)+", "", k)
        if ".all_modules." in k or k.startswith("decoder.encoder."):
            continue
        out[k] = v
    return out
