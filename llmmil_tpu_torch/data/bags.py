"""Pathology feature-bag handling: padding and bucketing.

Bags are padded to the smallest power-of-2-ish *bucket* and carry a validity
mask: few distinct shapes reach the model, little padding is computed on,
and the masked softmax downstream is exact.  Train-time instance dropout and
the native C++ packer of the JAX package are not ported yet.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

DEFAULT_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384)


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
