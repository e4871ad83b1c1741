"""Activation functions."""

from __future__ import annotations

import torch


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's QuickGELU: ``x * sigmoid(1.702 x)``."""
    return x * torch.sigmoid(1.702 * x)
