"""Reading ``nextou_tpu`` ``.ckpt`` checkpoints in the port
(``nextou_tpu_torch.compat.flax_ckpt``), on the CPU, against what
``nextou_tpu.train.checkpoint`` writes and restores.

A ``.ckpt`` of the JAX trainer reads back bit-equal (the network, optax's
momentum and the step), in a process that imports neither jax, flax nor
msgpack (``tests/test_torch_trajectory.py`` resumes a JAX fold in the
port); ``predict -chk *.ckpt`` serves the same probabilities as the same
weights in a ``.pth``;
``-pretrained_weights *.ckpt`` reports what the JAX package's
``restore_pretrained`` reports and loads the same values; flax's chunked
arrays decode; a pickle that names any other global than builtins'
containers and numpy's array reconstruction is refused.
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from nextou_tpu.data import make_synthetic_dataset
from nextou_tpu.train import get_trainer_class as jax_trainer_class
from nextou_tpu.train.checkpoint import restore_pretrained as jax_restore_pretrained
from nextou_tpu_torch import predict
from nextou_tpu_torch.compat import variables_to_state_dict
from nextou_tpu_torch.compat.flax_ckpt import msgpack_restore, read_ckpt
from nextou_tpu_torch.train import get_trainer_class
from nextou_tpu_torch.train.checkpoint import restore_pretrained
from tests.test_torch_model import randomized
from tests.test_train_integration import DATASET_JSON, TINY_PLANS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "2d_tiny"
DATASET_JSON_4 = {**DATASET_JSON, "labels": {**DATASET_JSON["labels"], "c": 3}}


def _jax_trainer(name, folder, out, dataset_json=DATASET_JSON, plans=TINY_PLANS):
    return jax_trainer_class(name)(
        plans, CONFIG, 0, dataset_json, preprocessed_folder=folder, output_folder=out,
        compute_dtype=jnp.float32).initialize()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX NexToU trainer's state with randomized parameters and
    statistics, saved by ``nextou_tpu.train.checkpoint.save_checkpoint``."""
    root = tmp_path_factory.mktemp("ckpt")
    folder = str(root / "data")
    make_synthetic_dataset(folder, n_cases=4, shape=(64, 64), num_classes=3)
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(TINY_PLANS, f)
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump(DATASET_JSON, f)
    trainer = _jax_trainer("nnUNetTrainer_NexToU", folder, str(root / "model"))
    variables = randomized(jax.device_get(trainer.state.model_variables()), 0)
    trainer.state = trainer.state.replace(params=variables["params"],
                                          batch_stats=variables["batch_stats"])
    trainer.log_history = [{"epoch": 0, "train_loss": 1.25, "pseudo_dice": [0.5, 0.25]}]
    trainer.save_checkpoint("checkpoint_final.ckpt")
    return {"folder": folder, "model": str(root / "model"), "trainer": trainer,
            "ckpt": str(root / "model" / "checkpoint_final.ckpt")}


def test_ckpt_reads_back_bit_equal(saved):
    variables, extra, momentum, step = read_ckpt(saved["ckpt"])
    state = jax.device_get(saved["trainer"].state)
    trace = next(s for s in state.opt_state if "trace" in s._fields).trace
    for got, want in ((variables, state.model_variables()), (momentum, trace)):
        flat_want = jax.tree_util.tree_leaves_with_path(want)
        flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_got) == len(flat_want) > 0
        for path, w in flat_want:
            g = flat_got[path]
            assert g.dtype == np.asarray(w).dtype and g.shape == np.shape(w), path
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(path))
    assert step == int(state.step) == 0
    assert extra["trainer"] == "nnUNetTrainer_NexToU" and extra["configuration"] == CONFIG
    assert extra["log_history"] == saved["trainer"].log_history
    # the whole state, step and optimizer state included, as flax restores it
    with open(saved["ckpt"], "rb") as f:
        state_bytes = pickle.load(f)["state_bytes"]
    everything = msgpack_restore(state_bytes)
    flax_view = serialization.msgpack_restore(state_bytes)
    assert jax.tree_util.tree_structure(everything) == jax.tree_util.tree_structure(flax_view)
    for a, b in zip(jax.tree_util.tree_leaves(everything), jax.tree_util.tree_leaves(flax_view)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_predict_serves_a_ckpt_like_the_same_pth(saved, tmp_path):
    model = saved["model"]
    variables = read_ckpt(saved["ckpt"]).variables
    spec = predict.load_dataset(saved["folder"], CONFIG)[2]
    torch.save({"network_weights": variables_to_state_dict(variables, spec)},
               os.path.join(model, "checkpoint_final.pth"))
    out = {}
    for chk in ("checkpoint_final.ckpt", "checkpoint_final.pth"):
        out[chk] = str(tmp_path / chk)
        predict.main([model, saved["folder"], CONFIG, "-chk", chk, "-o", out[chk],
                      "--save-probabilities", "--cases", "case_000", "--device", "cpu"])
    with np.load(os.path.join(out["checkpoint_final.ckpt"], "case_000.npz")) as a, \
            np.load(os.path.join(out["checkpoint_final.pth"], "case_000.npz")) as b:
        assert a["probabilities"].shape == (64, 64, 3)
        np.testing.assert_array_equal(a["probabilities"], b["probabilities"])
        np.testing.assert_array_equal(a["seg"], b["seg"])


@pytest.mark.parametrize("source,dataset_json", [
    ("nnUNetTrainer_NexToU", DATASET_JSON_4),  # another label count: the heads are skipped
    ("nnUNetTrainer", DATASET_JSON),  # a PlainConvUNet: the graph blocks are missing
])
def test_pretrained_ckpt_reports_what_the_jax_package_reports(saved, source, dataset_json,
                                                              tmp_path):
    ckpt = saved["ckpt"]
    if source != "nnUNetTrainer_NexToU":
        _jax_trainer(source, saved["folder"], str(tmp_path / "src")).save_checkpoint("c.ckpt")
        ckpt = str(tmp_path / "src" / "c.ckpt")
    target = _jax_trainer("nnUNetTrainer_NexToU", saved["folder"], str(tmp_path / "jax"),
                          dataset_json)
    jstate, want = jax_restore_pretrained(target.state, ckpt)
    port = get_trainer_class("nnUNetTrainer_NexToU")(
        TINY_PLANS, CONFIG, 0, dataset_json, preprocessed_folder=saved["folder"],
        output_folder=str(tmp_path / "port"), device="cpu").initialize()
    fresh = {k: v.clone() for k, v in port.network.state_dict().items()}
    _, got = restore_pretrained(port.state, ckpt)
    for key in ("loaded", "skipped_shape", "missing"):
        assert len(got[key]) == len(want[key]), (key, got[key], want[key])
    assert len(got["loaded"]) > 0
    if source == "nnUNetTrainer_NexToU":
        assert all(n.startswith("decoder.seg_layers.") for n in got["skipped_shape"])
        assert all("seg_head_" in n for n in want["skipped_shape"])
        assert not got["missing"]
    else:
        assert got["missing"] and all(".blocks.0." in n for n in got["missing"])
    # what was loaded holds the values the JAX package loaded
    restored = variables_to_state_dict(jax.device_get(jstate.model_variables()),
                                       port.model_spec)
    now = port.network.state_dict()
    for name in got["loaded"]:
        torch.testing.assert_close(now[name], restored[name], rtol=0, atol=0, msg=name)
    for name in got["skipped_shape"] + got["missing"]:
        assert torch.equal(now[name], fresh[name]), name


def test_chunked_array_decodes(monkeypatch):
    tree = {"w": np.arange(37 * 3, dtype=np.float32).reshape(37, 3),
            "b": {"i": np.arange(5, dtype=np.int64)}}
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = msgpack_restore(data)
    np.testing.assert_array_equal(got["w"], tree["w"])
    np.testing.assert_array_equal(got["b"]["i"], tree["b"]["i"])
    assert got["w"].dtype == np.float32


def test_pickle_naming_another_global_is_refused(tmp_path):
    class Exploit:
        def __reduce__(self):
            return (os.system, ("echo pwned",))

    path = tmp_path / "evil.ckpt"
    with open(path, "wb") as f:
        pickle.dump({"state_bytes": b"\x80", "extra": Exploit()}, f, protocol=4)
    with pytest.raises(pickle.UnpicklingError, match="may not name the global"):
        read_ckpt(str(path))
    with pytest.raises(ValueError, match="ext code"):
        msgpack_restore(b"\xd4\x05\x00")


def test_ckpt_reading_imports_neither_jax_flax_nor_msgpack(saved):
    code = (
        "import sys, torch\n"
        "from nextou_tpu_torch import predict\n"
        "from nextou_tpu_torch.compat.flax_ckpt import read_ckpt\n"
        f"variables, extra, momentum, step = read_ckpt({saved['ckpt']!r})\n"
        f"spec = predict.load_dataset({saved['folder']!r}, {CONFIG!r})[2]\n"
        f"model = predict.load_model(spec, {saved['ckpt']!r}, torch.device('cpu'))\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'msgpack', 'nextou_tpu')))"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"

