"""Pathology feature-bag handling: instance dropout, padding and bucketing.

Train-time instance dropout keeps a sorted random 90 % (Biopsy) / 80 %
(Resection) of a bag's rows.  Bags are padded to the smallest power-of-2-ish
*bucket* and carry a validity mask: few distinct shapes reach the model,
little padding is computed on, and the masked softmax downstream is exact.
The native C++ packer of the JAX package is not ported (ROADMAP.md, Queue 1
item 11); its numpy path is.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384)


def instance_dropout(feat: np.ndarray, kind: str,
                     rng: np.random.RandomState) -> np.ndarray:
    """Keep a sorted random 90 % (Biopsy) / 80 % (Resection) of the rows,
    drawing from ``rng`` as the JAX package does."""
    n = feat.shape[0]
    keep = int(n * (0.9 if kind == "Biopsy" else 0.8))
    return feat[np.sort(rng.choice(n, size=keep, replace=False))]


def bucket_for(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket ≥ n (last bucket caps)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def pad_bag(feat: np.ndarray, target: int
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad (n, d) to (target, d) + bool validity mask; truncates if
    n > target (keeps the first rows, like the reference's fixed buffer)."""
    n, d = feat.shape
    if n >= target:
        if feat.dtype == np.float32:
            # a full bucket needs only a slice view, not a copy
            return feat[:target], np.ones(target, bool)
        return (np.asarray(feat[:target], dtype=np.float32),
                np.ones(target, bool))
    out = np.zeros((target, d), dtype=np.float32)
    out[:n] = feat
    mask = np.zeros(target, bool)
    mask[:n] = True
    return out, mask
