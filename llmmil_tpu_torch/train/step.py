"""Single-device train and eval steps (the JAX package's ``train/step.py``).

The train step is the reference's per-batch loop body: forward in training
mode (dropout on, BatchNorm on the batch's statistics, which move the
running ones), multi-head loss, backward, optimizer update.  The JAX
package's step is one jitted program; here it runs eagerly and updates the
state in place.  Dropout draws from a generator seeded by the configuration's
seed and the step counter (the JAX step folds the counter into its key), so
a resumed run repeats the interrupted run's masks; the caller's random state
is left as it was.

The parallel modes of the JAX step (pipeline- and tensor-parallel CLIP,
depth-sharded CT) and its MoE branch are not ported: they raise, naming their
ROADMAP.md item.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import Config
from .losses import multihead_loss
from .state import TrainState


def _refuse_unported(cfg: Config) -> None:
    for field, item in (("pp_axis", 10), ("tp_axis", 10), ("fsdp_axis", 10),
                        ("ep_axis", 10), ("ct_shard_axis", 10)):
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r}: the parallel train step is "
                f"not ported yet (ROADMAP.md, Queue 1 item {item}: "
                "parallel/*)")
    if cfg.moe_experts:
        raise NotImplementedError(
            "moe_experts: the MoE blocks and their auxiliary loss are not "
            "ported yet (ROADMAP.md, Queue 1 item 5: moe.py)")


def dropout_seed(cfg: Config, step: int) -> int:
    return (int(cfg.seed) * 1_000_003 + int(step)) % (2 ** 63)


def _devices(model) -> list:
    p = next(model.parameters())
    return [p.device.index or 0] if p.is_cuda else []


def _metrics(terms: Dict, probs, label) -> Dict:
    out = {k: v.detach() for k, v in terms.items()}
    preds = probs.argmax(dim=-1)
    out["acc"] = (preds == label.argmax(dim=-1)).float().mean()
    out["probs"] = probs.detach()
    return out


def make_train_step(cfg: Config):
    """Returns ``step(state, batch) -> (state, metrics)``.  ``batch`` holds
    the model's inputs and 'label' (B, num_classes) one-hot targets, on the
    model's device; the metrics stay on the device until read."""
    _refuse_unported(cfg)

    def step(state: TrainState, batch: Dict) -> tuple:
        model = state.model
        if not model.training:      # a caller's finer setting is kept
            model.train()
        with torch.random.fork_rng(devices=_devices(model)):
            torch.manual_seed(dropout_seed(cfg, state.step))
            out = model(batch)
            terms = multihead_loss(out, batch["label"], cfg.loss_point,
                                   cfg.loss, cfg.num_classes)
            terms["loss"].backward()
        state.optimizer.step()
        state.optimizer.zero_grad()
        state.step += 1
        return state, _metrics(terms, out["probs"], batch["label"])

    return step


def make_eval_step(cfg: Config):
    """No-grad mirror of the train step, the model in eval mode."""

    def step(state: TrainState, batch: Dict) -> Dict:
        model = state.model
        model.eval()
        with torch.no_grad():
            out = model(batch)
            terms = multihead_loss(out, batch["label"], cfg.loss_point,
                                   cfg.loss, cfg.num_classes)
        return _metrics(terms, out["probs"], batch["label"])

    return step
