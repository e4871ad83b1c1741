"""Checkpointing: per-epoch saves, best-AUC copy, resume, partial restore
(the JAX package's ``train/checkpoint.py``, with ``torch.save`` in place of
flax msgpack).

A checkpoint is one file, ``checkpoint_{epoch:04d}.pt``, holding
``{epoch, step, batch_in_epoch, model, optimizer}``: ``epoch`` is the epoch
to resume at and ``batch_in_epoch`` the batches of it already applied (0
after a whole epoch); ``model`` is the state_dict (parameters and BatchNorm
running statistics), ``optimizer`` the :class:`~.optim.Optimizer`'s.  Each
save also copies the file to ``checkpoint_last.pt`` (and
``checkpoint_best.pt``).  Files are read with ``weights_only=True``.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict

import torch

from .state import TrainState


def _ckpt_dict(state: TrainState, next_epoch: int,
               batch_in_epoch: int = 0) -> Dict:
    return {"epoch": int(next_epoch), "step": int(state.step),
            "batch_in_epoch": int(batch_in_epoch),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict()}


def _map_tensors(tree: Any, fn) -> Any:
    """``fn`` applied to every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree.detach())
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _to_host(tree: Any) -> Any:
    return _map_tensors(tree, lambda t: t.to("cpu", copy=True))


def _write_ckpt(tree: Dict, save_dir: str, epoch: int,
                is_best: bool) -> str:
    path = os.path.join(save_dir, f"checkpoint_{epoch:04d}.pt")
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    shutil.copyfile(path, os.path.join(save_dir, "checkpoint_last.pt"))
    if is_best:
        shutil.copyfile(path, os.path.join(save_dir, "checkpoint_best.pt"))
    return path


def save_checkpoint(state: TrainState, save_dir: str, epoch: int,
                    is_best: bool = False, next_epoch: int | None = None,
                    batch_in_epoch: int = 0) -> str:
    """``checkpoint_{epoch:04d}`` + ``checkpoint_last`` (+ best copy).
    ``next_epoch`` overrides the resume point (default ``epoch + 1``); a
    mid-epoch save passes ``epoch`` and the number of batches applied."""
    ne = epoch + 1 if next_epoch is None else next_epoch
    return _write_ckpt(_to_host(_ckpt_dict(state, ne, batch_in_epoch)),
                       save_dir, epoch, is_best)


class AsyncCheckpointer:
    """Overlaps the device-to-host copy and the write with training.

    ``save_checkpoint`` copies the state's tensors on their device (new
    buffers, so the training loop's in-place updates cannot reach them) and
    returns; a thread then copies them to the host and writes the file.  At
    most one save is in flight: a new save, or :meth:`wait`, joins the
    previous one first and raises any error it met.  Call :meth:`wait`
    before reading the files or exiting."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None

    def save_checkpoint(self, state: TrainState, save_dir: str, epoch: int,
                        is_best: bool = False, next_epoch: int | None = None,
                        batch_in_epoch: int = 0) -> str:
        self.wait()
        ne = epoch + 1 if next_epoch is None else next_epoch
        snap = _map_tensors(_ckpt_dict(state, ne, batch_in_epoch),
                            torch.Tensor.clone)
        done = None
        if torch.cuda.is_available() and any(
                p.is_cuda for p in state.model.parameters()):
            done = torch.cuda.Event()
            done.record()

        def work():
            try:
                if done is not None:
                    done.synchronize()
                _write_ckpt(_to_host(snap), save_dir, epoch, is_best)
            except BaseException as e:          # raised by the next wait()
                self._exc = e

        self._thread = threading.Thread(target=work, name="async-ckpt",
                                        daemon=True)
        self._thread.start()
        return os.path.join(save_dir, f"checkpoint_{epoch:04d}.pt")

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc


def _resolve(path: str) -> str:
    """Accept run directories, stem names or file paths."""
    if os.path.isdir(path):
        for cand in ("checkpoint_best.pt", "checkpoint_last.pt"):
            p = os.path.join(path, cand)
            if os.path.exists(p):
                return p
    if not path.endswith(".pt") and os.path.exists(path + ".pt"):
        return path + ".pt"
    return path


def load_checkpoint(path: str) -> Dict:
    """The raw checkpoint dict, tensors on the CPU."""
    return torch.load(_resolve(path), map_location="cpu", weights_only=True)


def resume(state: TrainState, path: str) -> tuple:
    """Restore parameters, BatchNorm statistics, optimizer state and the
    step counter; returns ``(state, start_epoch, start_batch)``."""
    raw = load_checkpoint(path)
    state.model.load_state_dict(raw["model"], strict=True)
    state.optimizer.load_state_dict(raw["optimizer"])
    # the step counter seeds the train step's dropout: without it a resumed
    # run would replay the first steps' masks
    state.step = int(raw.get("step", 0))
    return state, int(raw["epoch"]), int(raw.get("batch_in_epoch", 0))


def restore_for_eval(state: TrainState, path: str) -> TrainState:
    """Restore only parameters and BatchNorm statistics, so that a
    checkpoint trained with another optimizer configuration evaluates."""
    state.model.load_state_dict(load_checkpoint(path)["model"], strict=True)
    return state


def restore_branch(state: TrainState, ckpt_path: str,
                   branch: str) -> TrainState:
    """Copy a saved checkpoint's ``branch.*`` entries into the live model by
    key intersection: only keys present in both, with matching shapes."""
    saved = load_checkpoint(ckpt_path)["model"]
    live = state.model.state_dict()
    pre = branch + "."
    merged = {k: v for k, v in saved.items() if k.startswith(pre)
              and k in live and tuple(v.shape) == tuple(live[k].shape)}
    if merged:
        state.model.load_state_dict(merged, strict=False)
    return state
