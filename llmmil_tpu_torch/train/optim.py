"""Optimizer and learning-rate schedule (the JAX package's
``train/optim.py``).

The JAX package builds an optax chain: coupled L2 decay 1e-7
(``add_decayed_weights``) before plain SGD when ``learnablePrompt`` is set,
before ``scale_by_adam`` otherwise; frozen branches under
``multi_transform(..., set_to_zero)``; ``MultiSteps`` for ``grad_accum``.
Here the same arithmetic is ``torch.optim.SGD`` / ``Adam`` with their
``weight_decay`` (coupled: ``g + wd·p``; Adam's eps outside the square root,
as optax's), inside :class:`Optimizer`, which adds what optax's wrappers do:

- the epoch-granular schedule, read at each applied update from the count of
  updates so far (optax's schedule count), epoch = count // steps_per_epoch;
- frozen branches (``pretrainedExt_freeze``) are left out of the optimizer
  and stop requiring grad: no update, no decay, no state;
- ``grad_accum`` > 1 averages the gradients of that many calls with
  ``MultiSteps``' running mean and applies one update on the last.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn as nn

from ..config import Config

WEIGHT_DECAY = 1e-7


def effective_lr(cfg: Config) -> float:
    """The reference's runtime lr rule: 1e-3 under ``learnablePrompt`` (the
    default), else 1e-3 above two classes and 1e-5 otherwise."""
    if cfg.learnablePrompt:
        return 1e-3
    return 1e-3 if cfg.num_classes > 2 else 1e-5


def lr_at_epoch(cfg: Config, epoch: int) -> float:
    """Cosine over ``n_epochs`` when ``cos``, else ×0.1 at each milestone
    of ``schedule``."""
    base = effective_lr(cfg)
    if cfg.cos:
        return base * 0.5 * (1.0 + math.cos(
            math.pi * epoch / max(cfg.n_epochs, 1)))
    factor = 1.0
    for milestone in cfg.schedule:
        if epoch >= milestone:
            factor *= 0.1
    return base * factor


def make_lr_schedule(cfg: Config, steps_per_epoch: int
                     ) -> Callable[[int], float]:
    """count of applied updates → learning rate."""
    spe = max(steps_per_epoch, 1)
    return lambda count: lr_at_epoch(cfg, count // spe)


def frozen_prefixes_from_config(cfg: Config) -> List[str]:
    out = []
    if cfg.pretrainedExt_freeze:
        if cfg.pretrainedExt_CT and "CT" in cfg.modality:
            out.append("extractor_CT")
        if cfg.pretrainedExt_pathology and "pathology" in cfg.modality:
            out.append("extractor_pathology")
        if cfg.pretrainedExt_CI and "CI" in cfg.modality:
            out.append("clinic_extractor")
    return out


class Optimizer:
    """The optax chain's counterpart over ``model``'s parameters.
    ``steps_per_epoch`` counts gradient applications (loaded batches ×
    ``data_echo``); with ``grad_accum`` the schedule's horizon is divided by
    it, as the JAX package divides it."""

    def __init__(self, cfg: Config, model: nn.Module,
                 steps_per_epoch: int = 100):
        self.accum = max(int(cfg.grad_accum), 1)
        self.schedule = make_lr_schedule(
            cfg, max(steps_per_epoch // self.accum, 1))
        frozen = tuple(frozen_prefixes_from_config(cfg))
        self.names, self.params = [], []
        for name, p in model.named_parameters():
            if name.split(".")[0] in frozen:
                p.requires_grad_(False)
            else:
                self.names.append(name)
                self.params.append(p)
        self.frozen = frozen
        lr = self.schedule(0)
        if cfg.learnablePrompt:
            self.inner = torch.optim.SGD(self.params, lr=lr,
                                         weight_decay=WEIGHT_DECAY)
        else:
            self.inner = torch.optim.Adam(self.params, lr=lr,
                                          betas=(cfg.b1, cfg.b2), eps=1e-8,
                                          weight_decay=WEIGHT_DECAY)
        self.count = 0          # updates applied (the schedule's count)
        self.mini_step = 0      # calls accumulated towards the next one
        self.acc: List[torch.Tensor] | None = None

    def step(self) -> bool:
        """Consume the gradients in ``.grad``; returns whether an update was
        applied.  A parameter the loss did not reach counts a zero gradient
        (optax decays it all the same)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        if self.accum > 1:
            n = self.mini_step
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.accum:
                return False
            grads, self.acc, self.mini_step = self.acc, None, 0
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = self.schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        self.count += 1
        return True

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self) -> Dict:
        return {"inner": self.inner.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc,
                "names": list(self.names)}

    def load_state_dict(self, sd: Dict) -> None:
        if list(sd["names"]) != self.names:
            raise ValueError("optimizer state of another parameter set "
                             "(a different freezing or model)")
        self.inner.load_state_dict(sd["inner"])
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        acc = sd["acc"]
        self.acc = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.params)]
