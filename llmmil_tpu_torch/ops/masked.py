"""Masked reductions for variable-length instance bags.

Every op takes an optional boolean ``mask`` (True = valid).  ``mask=None``
reproduces the reference's unmasked numerics exactly.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor | None,
                   dim: int = -1) -> torch.Tensor:
    """Numerically-stable softmax ignoring masked positions.

    ``mask`` broadcasts against ``logits``; masked positions get probability
    exactly 0 (all-masked slices return all-zero, not NaN).
    """
    if mask is not None:
        logits = logits.masked_fill(~mask, _NEG_INF)
    m = logits.amax(dim=dim, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m)
    if mask is not None:
        e = e.masked_fill(~mask, 0.0)
    denom = e.sum(dim=dim, keepdim=True)
    return e / denom.clamp_min(1e-30)


def masked_mean(x: torch.Tensor, mask: torch.Tensor | None,
                dim: int = -2) -> torch.Tensor:
    """Mean over ``dim`` counting only valid rows."""
    if mask is None:
        return x.mean(dim=dim)
    mask = mask.unsqueeze(-1).expand_as(x)
    num = torch.where(mask, x, torch.zeros_like(x)).sum(dim=dim)
    den = mask.sum(dim=dim).clamp_min(1)
    return num / den


def segment_mean_landmarks(x: torch.Tensor, num_landmarks: int,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Landmark means for Nyström attention: split N tokens into
    ``num_landmarks`` contiguous segments and mean each (masked-aware).

    x: (..., N, D) with N divisible by num_landmarks.  Returns
    (..., num_landmarks, D).
    """
    *lead, n, d = x.shape
    seg = n // num_landmarks
    xs = x.reshape(*lead, num_landmarks, seg, d)
    if mask is None:
        return xs.mean(dim=-2)
    ms = mask.expand(*lead, n).reshape(*lead, num_landmarks, seg, 1)
    num = torch.where(ms, xs, torch.zeros_like(xs)).sum(dim=-2)
    den = ms.sum(dim=-2).to(x.dtype).clamp_min(1.0)
    return num / den
