"""End-to-end Dice of the port's training against ``nextou_tpu``'s, on the
CPU, on a task that does not saturate, with host augmentation and the BTI
loss.

The data: 15 preprocessed 2D cases of 64 x 64 with 3 labels. In each an
ellipse is cut by a random line into label 1 and label 2, so the two
foreground labels touch and ``nnUNetTrainer_NexToU_BTI_RAVIR``'s exclusion
``[[1, 2]]`` has a boundary to act on. Their intensities are +1.2 and -1.2
over a background of 0, under unit Gaussian noise and a smooth bias field
of amplitude 0.5: a contrast of 1.2 sigma per voxel, which a network can
only resolve over a neighbourhood.

Both packages' ``run_training`` train the BTI trainer on fold 0 (12 cases
for training, 3 held out) at the 2d_tiny plans of
``tests/test_train_integration.py``, 8 epochs x 20 iterations with their
default host augmentation and 5 eval steps per epoch (cut from 50), then
validate on the held-out cases. The port starts from the JAX trainer's
initial weights (``-pretrained_weights`` of its ``.ckpt``), in one torch
thread (on an 8-core CPU the test takes 91 s so, 223 s in eight); the JAX
package draws its batches in one loader thread (its queue is shared by its
threads, so two would make the run nondeterministic), the port in its
default two (served in turn: a function of the seed).

The bar, on each package's ``validation/summary.json``: each foreground
label's mean Dice in [0.3, 0.95], and |port - JAX| per label within
max(1.5 x the JAX package's seed-to-seed spread, 0.03). The spread
(:data:`SEED_SPREAD`) was measured once, on this test's data and settings,
over the JAX trainer's seeds 12345 (its default), 1 and 2 on the CPU: the
largest difference between two of the three runs, per label. The JAX
trainer runs on one device (the tests' eight virtual CPU devices would
shard its batch over two).

Why these settings: the task has to end in the same place at every seed,
or the spread, and with it the bar, is wide. With 8 cases (2 held out) at
0.8 sigma and 6 x 20, the seeds' Dice of label 2 spread over 0.27 (0.58 to
0.85); at 1.0 sigma and 8 x 20 on 15 cases one seed still ended with label
2 at 0.40, and at 1.2 sigma and 6 x 20 one seed had not yet learned label
1 (Dice 0). At 1.2 sigma and 8 x 20 the JAX seeds 12345, 1, 2, 3 and 4
gave 0.935, 0.930, 0.909, 0.937, 0.924 (label 1) and 0.939, 0.929, 0.931,
0.922, 0.940 (label 2), and the port 0.929 and 0.920.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
from scipy import ndimage

from nextou_tpu import run_training as jax_run_training
from nextou_tpu.train import get_trainer_class as jax_trainer_class
from nextou_tpu_torch import run_training
from nextou_tpu_torch.data.dataset import save_case
from nextou_tpu_torch.train import get_trainer_class
from tests.test_train_integration import TINY_PLANS

CONFIG = "2d_tiny"
TRAINER = "nnUNetTrainer_NexToU_BTI_RAVIR"
EPOCHS, ITERS, EVAL_STEPS = 8, 20, 5
CONTRAST = 1.2
N_CASES = 15
DATASET_JSON = {"labels": {"background": 0, "a": 1, "b": 2}, "numTraining": N_CASES,
                "channel_names": {"0": "img"}}
# label -> the JAX package's seed-to-seed spread of the validation Dice: its
# seeds 12345, 1 and 2 gave 0.9351, 0.9302, 0.9093 (label 1) and 0.9392,
# 0.9285, 0.9313 (label 2)
SEED_SPREAD = {"1": 0.0258, "2": 0.0107}


def make_case(rng, shape=(64, 64)):
    """(data (1, *shape) f32, seg (*shape) int16): an ellipse split into
    labels 1 and 2 along a random line through its centre."""
    yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape], indexing="ij")
    cy, cx = rng.uniform(26, 38, 2)
    ry, rx = rng.uniform(12.6, 22.4, 2)
    inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    angle = rng.uniform(0, np.pi)
    side = (yy - cy) * np.cos(angle) - (xx - cx) * np.sin(angle) > 0
    seg = np.zeros(shape, np.int16)
    seg[inside & side] = 1
    seg[inside & ~side] = 2
    bias = ndimage.gaussian_filter(rng.normal(0, 1, shape), 16)
    bias *= 0.5 / np.abs(bias).max()
    means = np.array([0.0, CONTRAST, -CONTRAST])
    data = means[seg] + bias + rng.normal(0, 1, shape)
    return data[None].astype(np.float32), seg


def write_dataset(folder: str, n_cases: int = N_CASES, seed: int = 0) -> str:
    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_cases):
        save_case(folder, f"case_{i:03d}", *make_case(rng))
    with open(os.path.join(folder, "nnUNetPlans.json"), "w") as f:
        json.dump(TINY_PLANS, f)
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump(DATASET_JSON, f)
    return folder


def mean_dice(folder: str) -> dict:
    with open(os.path.join(folder, "validation", "summary.json")) as f:
        return {label: m["Dice"] for label, m in json.load(f)["mean"].items() if label != "0"}


@pytest.fixture
def one_torch_thread():
    """The port's side in one thread: its tensors are small, and the tests
    run beside others on the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.slow  # two trainings end to end: 91 s alone, 154 s among the tier-1 run's six
# workers, where it took that run from about 1,120 s to 1,270 s on an 8-core CPU
def test_port_and_jax_reach_the_same_dice(tmp_path, monkeypatch, one_torch_thread):
    monkeypatch.setenv("NEXTOU_LOADER_THREADS", "1")
    monkeypatch.setattr(jax, "device_count", lambda: 1)
    for trainer_class in (jax_trainer_class(TRAINER), get_trainer_class(TRAINER)):
        monkeypatch.setattr(trainer_class, "num_val_iterations_per_epoch", EVAL_STEPS)
    data = write_dataset(str(tmp_path / "data"))
    init = jax_trainer_class(TRAINER)(
        os.path.join(data, "nnUNetPlans.json"), CONFIG, 0, DATASET_JSON,
        preprocessed_folder=data, output_folder=str(tmp_path / "init")).initialize()
    init.save_checkpoint("initial.ckpt")
    common = [data, CONFIG, "0", "-tr", TRAINER, "--epochs", str(EPOCHS), "--iters", str(ITERS)]
    jax_run_training.main(common + ["-o", str(tmp_path / "jax")])
    run_training.main(common + ["-o", str(tmp_path / "port"), "--device", "cpu",
                                "-pretrained_weights", str(tmp_path / "init" / "initial.ckpt")])
    want, got = mean_dice(str(tmp_path / "jax")), mean_dice(str(tmp_path / "port"))
    assert sorted(got) == sorted(want) == ["1", "2"]
    for label in ("1", "2"):
        assert 0.3 <= want[label] <= 0.95 and 0.3 <= got[label] <= 0.95, (label, got, want)
        bar = max(1.5 * SEED_SPREAD[label], 0.03)
        assert abs(got[label] - want[label]) <= bar, (label, got, want, bar)
