"""The epoch loop of training (the JAX package's ``train/loop.py``).

``fit`` builds the model and its train state, restores pretrained branches
or resumes a run (mid-epoch included), then per epoch trains, validates,
keeps the best-AUC checkpoint and handles preemption.  ``run_epoch`` is one
pass over a loader: ``data_echo`` applies each loaded batch that many times,
and the device-side metrics are read in batches of ``log_every`` steps, so
that the host does not wait for the card after every step.  AUC is taken on
P(class 1) over the whole epoch, with the reference's AUC of the argmax
predictions beside it as ``auc_argmax``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from ..config import Config, resolve_memory_config
from ..device import resolve_device
from ..models import build_model
from ..parallel.prefetch import prefetch_to_device
from ..utils import AverageMeter, MetricWriter, ProgressMeter
from ..utils.run_dir import dump_config, make_save_dir
from . import checkpoint as ckpt_lib
from .metrics import precision_recall, roc_auc, roc_auc_ovo_macro
from .preempt import PreemptionGuard
from .state import TrainState, create_train_state
from .step import make_eval_step, make_train_step

TERM_KEYS = ("loss_CT", "loss_Pth", "loss_Last", "loss_CosSim")


def _epoch_metrics(all_probs, all_labels, num_classes: int) -> Dict:
    if not all_probs:            # zero batches ran (preempted at once)
        return {"acc": 0.0, "auc": 0.0, "precision": 0.0, "recall": 0.0}
    probs = np.concatenate(all_probs)
    labels = np.concatenate(all_labels)
    y = np.argmax(labels, -1)
    preds = np.argmax(probs, -1)
    out = {"acc": float((preds == y).mean())}
    if num_classes == 2:
        out["auc"] = roc_auc(y, probs[:, 1])
        out["auc_argmax"] = roc_auc(y, preds)        # the reference's
        prec, rec = precision_recall(y, preds, "binary")
    else:
        prec, rec = precision_recall(y, preds, "macro")
        out["auc"] = roc_auc_ovo_macro(y, probs)
    out["precision"], out["recall"] = float(prec), float(rec)
    return out


def _model_device(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def run_epoch(step_fn, state: TrainState, loader, epoch: int, cfg: Config,
              train: bool, writer: Optional[MetricWriter] = None,
              guard: Optional[PreemptionGuard] = None):
    """One pass over ``loader``; returns (state, epoch metrics).  A latched
    ``guard`` reads the pending metrics and stops at the next step."""
    batch_time = AverageMeter("Time", ":6.3f")
    data_time = AverageMeter("Data", ":6.3f")
    losses = AverageMeter("Loss", ":.4e")
    accs = AverageMeter("Acc", ":6.2f")
    prefix = "Train" if train else "Valid"
    progress = ProgressMeter(len(loader), [batch_time, data_time, losses,
                                           accs],
                             prefix=f"{prefix} Epoch: [{epoch}]")
    term_meters: Dict[str, AverageMeter] = {}
    all_probs, all_labels = [], []
    pending = []                 # device-side metrics, read lazily

    def drain():
        for n_, m_, label_ in pending:
            losses.update(float(m_["loss"]), n_)
            accs.update(float(m_["acc"]), n_)
            for k in TERM_KEYS:
                if k in m_:
                    term_meters.setdefault(
                        k, AverageMeter(k, ":.4e")).update(float(m_[k]), n_)
            all_probs.append(m_["probs"].float().cpu().numpy())
            all_labels.append(np.asarray(label_))
        pending.clear()

    device = _model_device(state)
    epoch_start = end = time.time()
    n_batches = 0
    echo = max(int(cfg.data_echo), 1) if train else 1
    for i, batch in enumerate(prefetch_to_device(loader, cfg.device_prefetch,
                                                 device)):
        data_time.update(time.time() - end)
        host_label = batch.pop("_host_label")
        batch.pop("ID", None)
        n = host_label.shape[0]
        n_batches += 1
        for _ in range(echo):
            if train:
                state, metrics = step_fn(state, batch)
            else:
                metrics = step_fn(state, batch)
            pending.append((n, metrics, host_label))
        batch_time.update(time.time() - end)
        end = time.time()
        if i % cfg.log_every == 0:
            drain()
            progress.display(i)
        if guard is not None and guard.requested:
            break
    drain()

    em = _epoch_metrics(all_probs, all_labels, cfg.num_classes)
    em["loss"] = losses.avg
    wall = time.time() - epoch_start
    if n_batches:
        em["step_ms"] = 1e3 * wall / n_batches
        em["samples_per_s"] = losses.count / wall if wall else 0.0
    for k, m in term_meters.items():
        em[k] = m.avg
    if writer is not None:
        writer.add_scalars(em, epoch, prefix="train/" if train else "valid/")
    # bookkeeping for the preemption save, not a metric scalar
    em["n_batches"] = n_batches
    return state, em


def fit(cfg: Config, train_loader, valid_loader,
        save_dir: Optional[str] = None, n_epochs: Optional[int] = None,
        profile_dir: Optional[str] = None, device=None,
        state: Optional[TrainState] = None) -> Dict:
    """Full training run; returns a summary with the best validation AUC.

    ``device``: the CUDA card unless the caller names another.  ``state``:
    train from this state instead of a freshly built model (its model must
    be built for ``cfg``).  ``profile_dir``: a ``torch.profiler`` trace of
    the first training epoch is written there."""
    cfg = resolve_memory_config(cfg, training=True)
    device = resolve_device(device)
    save_dir = save_dir or make_save_dir(cfg)
    dump_config(cfg, save_dir)
    writer = MetricWriter(save_dir)

    echo = max(int(cfg.data_echo), 1)
    if state is None:
        # data echoing multiplies the updates of an epoch: the schedule's
        # horizon counts applications, not loaded batches
        state = create_train_state(build_model(cfg, device=device), cfg,
                                   steps_per_epoch=len(train_loader) * echo)

    start_epoch = cfg.start_epoch
    resume_batch = 0
    if cfg.resume:
        state, start_epoch, resume_batch = ckpt_lib.resume(state, cfg.resume)
        print(f"=> resumed from '{cfg.resume}' (epoch {start_epoch}"
              + (f", batch {resume_batch}" if resume_batch else "") + ")")
    else:
        for flag, path, branch in (
                (cfg.pretrainedExt_CT, cfg.pretrainedExt_CT_pth,
                 "extractor_CT"),
                (cfg.pretrainedExt_pathology,
                 cfg.pretrainedExt_pathology_pth, "extractor_pathology"),
                (cfg.pretrainedExt_CI, cfg.pretrainedExt_CI_pth,
                 "clinic_extractor")):
            if flag and path:
                state = ckpt_lib.restore_branch(state, path, branch)
                print(f"=> loaded pretrained {branch} from {path}")

    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    best_auc = 0.0
    summary: Dict = {}
    saver = (ckpt_lib.AsyncCheckpointer() if cfg.async_checkpoint
             else ckpt_lib)
    guard = (PreemptionGuard() if cfg.handle_preemption
             else PreemptionGuard(signals=()))
    try:
        with guard:
            for epoch in range(start_epoch, n_epochs or cfg.n_epochs):
                train_loader.set_epoch(epoch)
                print(save_dir)
                # mid-epoch resume: skip the batches the interrupted run
                # applied (the order is fixed by set_epoch)
                epoch_offset = 0
                if epoch == start_epoch and resume_batch:
                    if hasattr(train_loader, "skip_next"):
                        train_loader.skip_next(resume_batch)
                        epoch_offset = resume_batch
                        print(f"=> mid-epoch resume: skipping the "
                              f"{resume_batch} already-trained batches")
                    else:
                        print("=> loader has no skip_next hook; re-running "
                              "the interrupted epoch from batch 0")
                if profile_dir and epoch == start_epoch:
                    state, tm = _profiled_epoch(
                        profile_dir, train_step, state, train_loader, epoch,
                        cfg, writer, guard)
                else:
                    state, tm = run_epoch(train_step, state, train_loader,
                                          epoch, cfg, True, writer, guard)
                if guard.requested:
                    # preempted: checkpoint_last with the batch offset, so
                    # that --resume continues at the next batch; the last
                    # batch counts as a whole epoch (validation is lost)
                    done = epoch_offset + tm["n_batches"]
                    if done >= len(train_loader):
                        saver.save_checkpoint(state, save_dir, epoch)
                    else:
                        saver.save_checkpoint(state, save_dir, epoch,
                                              next_epoch=epoch,
                                              batch_in_epoch=done)
                    summary = {"epoch": epoch, "train": tm,
                               "best_auc": best_auc, "save_dir": save_dir,
                               "preempted": True}
                    print(f"=> preemption: checkpointed epoch {epoch} at "
                          f"batch {done}/{len(train_loader)}, exiting")
                    break
                _, vm = run_epoch(eval_step, state, valid_loader, epoch, cfg,
                                  False, writer, guard)
                if guard.requested:
                    # the train epoch completed: --resume continues at
                    # epoch + 1; truncated valid metrics pick no best
                    saver.save_checkpoint(state, save_dir, epoch)
                    summary = {"epoch": epoch, "train": tm,
                               "best_auc": best_auc, "save_dir": save_dir,
                               "preempted": True}
                    print(f"=> preemption during validation: checkpointed "
                          f"epoch {epoch}, exiting")
                    break
                is_best = vm["auc"] >= best_auc
                if is_best:
                    best_auc = vm["auc"]
                if (not cfg.save_best) or is_best:
                    saver.save_checkpoint(state, save_dir, epoch,
                                          is_best=is_best)
                summary = {"epoch": epoch, "train": tm, "valid": vm,
                           "best_auc": best_auc, "save_dir": save_dir}
    finally:
        if hasattr(saver, "wait"):
            saver.wait()      # the in-flight save, and its errors
        writer.close()
    summary["state"] = state
    return summary


def _profiled_epoch(profile_dir, step_fn, state, loader, epoch, cfg, writer,
                    guard):
    import os
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if _model_device(state).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        out = run_epoch(step_fn, state, loader, epoch, cfg, True, writer,
                        guard)
    prof.export_chrome_trace(os.path.join(profile_dir,
                                          f"train_epoch{epoch}.json"))
    return out


__all__ = ["fit", "run_epoch"]
