"""Graceful-preemption handling: checkpoint and exit cleanly on SIGTERM (the
JAX package's ``train/preempt.py``).

A :class:`PreemptionGuard` installed around the epoch loop latches SIGTERM
(pass ``signals`` to add SIGINT or others), the batch loop stops at the next
step boundary, and ``fit()`` writes ``checkpoint_last`` with the batch offset
before returning; ``--resume`` then continues the epoch at the next batch.

Signal handlers only work on the main thread; when installed elsewhere (e.g.
under pytest-xdist) the guard degrades to a manual flag (``request()``).
"""

from __future__ import annotations

import signal
import threading
from typing import Optional, Sequence


class PreemptionGuard:
    """Context manager latching termination signals into a checkable flag."""

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict = {}

    # -- flag --------------------------------------------------------
    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self) -> None:
        """Manually latch (tests; cooperative schedulers)."""
        self._event.set()

    # -- handler lifecycle --------------------------------------------
    def _handle(self, signum, frame) -> None:  # pragma: no cover - signal
        self._event.set()

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for s in self.signals:
                try:
                    self._prev[s] = signal.signal(s, self._handle)
                except (ValueError, OSError):
                    pass
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):
                pass
        self._prev.clear()
        return None
