"""Classification training (the port's counterpart of the JAX package's
``train/``): losses, schedules, optimizers, the train state with its EMA,
the train / eval steps, meters and the CLI (``train/cli.py``)."""

from mrla_tpu_torch.train.losses import (
    cross_entropy,
    distillation_loss,
    label_smoothing_ce,
    soft_target_ce,
)
from mrla_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    update_ema,
)
from mrla_tpu_torch.train.steps import eval_step, train_step

__all__ = [
    "TrainState",
    "create_train_state",
    "cross_entropy",
    "distillation_loss",
    "eval_step",
    "label_smoothing_ce",
    "soft_target_ce",
    "train_step",
    "update_ema",
]
