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
- relative-position constants ``(N, M)`` -> ``relative_pos`` ``(1, N, M)``.

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


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv_w(w) -> np.ndarray:
    w = np.asarray(w)
    nd = w.ndim - 2
    return np.transpose(w, (nd + 1, nd, *range(nd)))


def _transp_w(w) -> np.ndarray:
    w = np.asarray(w)
    nd = w.ndim - 2
    return np.transpose(w[(slice(None, None, -1),) * nd], (nd, nd + 1, *range(nd)))


def _norm(ref: str, p, s) -> dict:
    sd = {ref + ".weight": _t(p["scale"]), ref + ".bias": _t(p["bias"])}
    if s is not None:
        sd[ref + ".running_mean"] = _t(s["mean"])
        sd[ref + ".running_var"] = _t(s["var"])
        sd[ref + ".num_batches_tracked"] = torch.tensor(0)
    return sd


def _fc(ref: str, p, s, dims: int) -> dict:
    w = np.asarray(p["dense"]["kernel"])  # (I, O)
    return {
        ref + ".0.weight": _t(w.T.reshape(*w.T.shape, *([1] * dims))),
        ref + ".0.bias": _t(p["dense"]["bias"]),
        **_norm(ref + ".1", p["norm"], s["norm"]),
    }


def conv_blocks_state(params, stats) -> dict:
    """A ``StackedConvBlocks``' variables -> ``convs.{j}.conv/.norm``."""
    sd = {}
    for j in range(len(params)):
        p, s = params[f"block_{j}"], stats[f"block_{j}"]
        sd[f"convs.{j}.conv.weight"] = _t(_conv_w(p["conv"]["kernel"]))
        sd[f"convs.{j}.conv.bias"] = _t(p["conv"]["bias"])
        sd.update(_norm(f"convs.{j}.norm", p["norm"], s["norm"]))
    return sd


def grapher_state(params, stats, constants, *, graph_norm: str, dims: int) -> dict:
    """A Swin/Pool grapher's variables -> ``fc1``, ``graph_conv.gconv.nn``,
    ``fc2`` and ``relative_pos``. ``graph_norm`` is its graph conv's norm."""
    pn = params["graph_conv"]["gconv"]["nn"]
    g, ci, co = np.asarray(pn["dense_0"]["kernel"]).shape
    grouped = np.transpose(np.asarray(pn["dense_0"]["kernel"]), (0, 2, 1))
    sn = stats["graph_conv"]["gconv"]["nn"]["norm_0"] if graph_norm == "batch" else None
    (table,) = constants.values()
    return {
        **_fc("fc1", params["fc1"], stats["fc1"], dims),
        "graph_conv.gconv.nn.0.weight": _t(grouped.reshape(g * co, ci, *([1] * dims))),
        "graph_conv.gconv.nn.0.bias": _t(pn["dense_0"]["bias"]),
        **_norm("graph_conv.gconv.nn.1", pn["norm_0"], sn),
        **_fc("fc2", params["fc2"], stats["fc2"], dims),
        "relative_pos": _t(table)[None],
    }


def ffn_state(params, stats, dims: int) -> dict:
    return {
        **_fc("fc1", params["fc1"], stats["fc1"], dims),
        **_fc("fc2", params["fc2"], stats["fc2"], dims),
    }


def variables_to_state_dict(variables, spec: ModelSpec) -> dict[str, torch.Tensor]:
    """Map ``nextou_tpu`` NexToU variables onto this port's ``state_dict``."""
    params, stats = variables["params"], variables["batch_stats"]
    consts = variables["constants"]
    dims = spec.spatial_dims
    sd: dict[str, torch.Tensor] = {}

    def put(prefix: str, part: dict):
        sd.update({f"{prefix}.{k}": v for k, v in part.items()})

    def stage(our: str, base: str, st):
        conv_ref = base + ".0" if st.gnn else base
        put(conv_ref, conv_blocks_state(params[our]["convs"], stats[our]["convs"]))
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
    return sd


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
