from nextou_tpu_torch.train.optimizer import SGD, make_optimizer, poly_lr
from nextou_tpu_torch.train.state import TrainState, create_train_state
from nextou_tpu_torch.train.train_step import (
    make_eval_step,
    make_train_step,
    pseudo_dice,
)
