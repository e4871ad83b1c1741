"""Train state: the model (parameters and BatchNorm running statistics), its
optimizer and the step counter in one object (the JAX package's
``TrainState``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch.nn as nn

from .optim import Optimizer


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0


def create_train_state(model: nn.Module, cfg,
                       steps_per_epoch: int = 100) -> TrainState:
    """``model`` as ``build_model`` made it (its weights are the state's
    initial parameters)."""
    return TrainState(model, Optimizer(cfg, model, steps_per_epoch))
