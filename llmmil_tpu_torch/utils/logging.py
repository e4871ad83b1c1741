"""Metric logging as JSON lines (the JAX package's ``utils/logging.py`` without
its optional TensorBoard sink): one ``{"tag", "value", "step", "time"}``
object a line in ``<log_dir>/metrics.jsonl``, the reference's train/valid
scalars (loss and per-head losses, acc, auc, precision, recall)."""

from __future__ import annotations

import json
import os
import time


class MetricWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": int(step),
                                  "time": time.time()}) + "\n")
        self._f.flush()

    def add_scalars(self, scalars: dict, step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}{k}", v, step)

    def close(self) -> None:
        self._f.close()
