from nextou_tpu_torch.train.optimizer import SGD, make_optimizer, poly_lr
from nextou_tpu_torch.train.registry import TRAINER_REGISTRY, get_trainer_class, register_trainer
from nextou_tpu_torch.train.state import TrainState, create_train_state
from nextou_tpu_torch.train.train_step import (
    make_eval_step,
    make_train_step,
    pseudo_dice,
)
from nextou_tpu_torch.train import trainers as _trainers  # noqa: F401 (registers)
from nextou_tpu_torch.train.trainer import NexToUTrainer
