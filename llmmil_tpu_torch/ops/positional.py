"""Sinusoidal positional encodings.

``pe[p, 2i] = sin(p * exp(-2i ln(10000)/d))``, ``pe[p, 2i+1] = cos(...)``,
the reference's table.  Only the rows asked for are computed, on the host in
numpy so that the values are those of the JAX package bit for bit.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _pe_table(length: int, dim: int) -> np.ndarray:
    position = np.arange(length, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                      * -(math.log(10000.0) / dim))
    pe = np.zeros((length, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    pe.setflags(write=False)
    return pe


def sinusoidal_pe(length: int, dim: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """(length, dim) sinusoidal PE on ``device``."""
    table = torch.from_numpy(_pe_table(int(length), int(dim)).copy())
    return table.to(device=device, dtype=dtype)
