"""Training of the port: losses, metrics, optimizer and schedule, train
state, train / eval steps, checkpoints, preemption and the epoch loop
(``fit``); ``python -m llmmil_tpu_torch.train`` is the CLI."""

from .losses import multihead_loss
from .state import TrainState, create_train_state
from .step import make_eval_step, make_train_step

__all__ = ["multihead_loss", "TrainState", "create_train_state",
           "make_train_step", "make_eval_step"]
