"""Train state: parameters, BatchNorm statistics, momentum, step and the
generator's state in one object, counterpart of ``nextou_tpu/train/state.py``.

The parameters and the BatchNorm statistics live in the model (an
``nn.Module``); the state holds the model, the momentum buffers (one per
parameter, in ``model.named_parameters()`` order) and the step count. The
train step updates it in place. ``state_dict`` / ``load_state_dict`` save and
restore all of it, the state of the model's random generator included.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from nextou_tpu_torch.train.optimizer import SGD
from nextou_tpu_torch.utils.init import init_weights


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    momentum: list[torch.Tensor]
    step: int = 0

    def named_momentum(self) -> dict[str, torch.Tensor]:
        names = [name for name, _ in self.model.named_parameters()]
        return dict(zip(names, self.momentum))

    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(),
            "momentum": self.named_momentum(),
            "step": self.step,
            "generator": self.model.generator.get_state(),
        }

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        momentum = self.named_momentum()
        if momentum.keys() != sd["momentum"].keys():
            raise KeyError("momentum names do not match the model's parameters")
        with torch.no_grad():
            for name, buf in momentum.items():
                buf.copy_(sd["momentum"][name])
        self.step = int(sd["step"])
        self.model.generator.set_state(sd["generator"])


def create_train_state(model: nn.Module, optimizer: SGD, seed: int) -> TrainState:
    """Initialize ``model`` in place from ``seed`` (He normal, identity norm
    statistics), seed its generator with ``seed + 1``, and start the momentum
    at zero and the step at 0."""
    init_weights(model, seed)
    model.generator.manual_seed(seed + 1)
    return TrainState(model, optimizer.init(list(model.parameters())))
