"""Clinical-information MLP encoders (``simpleFCs_v1``, ``_v1d``, ``_v2``,
``_v2d``).  All map a clinical vector to a 512-d embedding; the "d" variants
consume the tiled ("duplicated") input the data pipeline produces.  The
``fc`` Sequential carries the reference's ``state_dict`` names (Linear layers
at ``fc.0`` / ``fc.2``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .layers import Dense


class SimpleFCsV1(nn.Module):
    """MLP n→n→512 with ReLU."""

    def __init__(self, n_features: int = 9,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = nn.Sequential(Dense(n_features, n_features, dtype),
                                nn.ReLU(), Dense(n_features, 512, dtype),
                                nn.ReLU())

    def forward(self, x):
        return self.fc(x)


class SimpleFCsV1d(nn.Module):
    """Linear on the tiled v1 vector → 512."""

    def __init__(self, n_features: int = 9,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_dim = n_features * math.ceil(512 / n_features)
        self.fc = nn.Sequential(Dense(self.in_dim, 512, dtype), nn.ReLU())

    def forward(self, x):
        if x.shape[-1] != self.in_dim:
            raise ValueError(f"expected {self.in_dim} tiled features, got "
                             f"{tuple(x.shape)}")
        return self.fc(x)


class SimpleFCsV2(SimpleFCsV1):
    """MLP 27→27→512 on one-hot input."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__(27, dtype)


class SimpleFCsV2d(nn.Module):
    """Linear 27·19→512 on tiled one-hot input."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc = nn.Sequential(Dense(27 * 19, 512, dtype), nn.ReLU())

    def forward(self, x):
        if x.shape[-1] != 27 * 19:
            raise ValueError(f"expected {27 * 19} tiled features, got "
                             f"{tuple(x.shape)}")
        return self.fc(x)
