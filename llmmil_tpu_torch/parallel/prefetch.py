"""Host-to-device prefetch: the copies of the next batches overlap the
current step (the JAX package's ``parallel/prefetch.py``; the reference's
``DataLoader(pin_memory=True)`` + ``.cuda(non_blocking=True)``).

A background thread takes batches from the loader, up to ``size`` ahead.
For a CUDA device it copies every array into a pinned host buffer and from
there to the card on a side stream, then records an event on that stream;
the consumer's stream waits on the event before the batch is handed out, and
every placed tensor is marked as used on the consumer's stream
(``record_stream``), so that the caching allocator does not hand its memory
to the side stream while the step still reads it.  For the CPU the arrays
become tensors (no copy).  Entries that are not arrays (``ID``) pass
through; the host label stays beside the batch as ``_host_label``, so that
the metrics never copy it back.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, Iterator

import numpy as np
import torch


def _host_tensor(a: np.ndarray, pin: bool) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not pin:
        return torch.from_numpy(a)
    t = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                    pin_memory=True)
    t.numpy()[...] = a
    return t


def place_batch(batch: Dict, device: torch.device) -> Dict:
    """Arrays of ``batch`` as tensors on ``device`` (copies issued on the
    current stream); other entries as they are."""
    out: Dict[str, Any] = {}
    pin = device.type == "cuda"
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = _host_tensor(v, pin)
        if isinstance(v, torch.Tensor):
            v = v.to(device, non_blocking=pin)
        out[k] = v
    return out


def prefetch_to_device(iterable: Iterable[Dict], size: int = 2,
                       device=None) -> Iterator[Dict]:
    """Iterate ``iterable``, placing up to ``size`` batches ahead on
    ``device``.  Errors of the source reach the consumer; abandoning the
    generator stops the thread."""
    device = torch.device(device or "cpu")
    if size <= 0:
        for batch in iterable:
            yield _with_host_label(place_batch(batch, device), batch)
        return
    q: "queue.Queue" = queue.Queue(maxsize=size)
    stop = threading.Event()
    end = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            side = torch.cuda.Stream(device) if device.type == "cuda" \
                else None
            for batch in iterable:
                if side is None:
                    item = (place_batch(batch, device), None, batch)
                else:
                    with torch.cuda.stream(side):
                        placed = place_batch(batch, device)
                        ready = torch.cuda.Event()
                        ready.record(side)
                    item = (placed, ready, batch)
                if not put(item):
                    return
        except BaseException as e:              # propagate to the consumer
            put(e)
            return
        put(end)

    t = threading.Thread(target=worker, daemon=True, name="device-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is end:
                break
            if isinstance(item, BaseException):
                raise item
            placed, ready, batch = item
            if ready is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(ready)
                for v in placed.values():
                    if isinstance(v, torch.Tensor):
                        v.record_stream(current)
            yield _with_host_label(placed, batch)
    finally:
        stop.set()
        t.join(timeout=5)


def _with_host_label(placed: Dict, batch: Dict) -> Dict:
    if "label" in batch:
        placed["_host_label"] = np.asarray(batch["label"])
    return placed
