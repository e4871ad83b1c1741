"""Gated-attention MIL pooling (Ilse et al.) as plain functions.

    A_V = tanh(x @ Wv + bv)            # (N, D)
    A_U = sigmoid(x @ Wu + bu)         # (N, D)
    a   = (A_V * A_U) @ Ww + bw        # (N, K)
    A   = softmax(a over N)            # (K, N)
    M   = A @ x                        # (K, L)

Batched over bags and mask-aware; ``mask=None`` matches the reference
exactly.  The fused CUDA kernel in ``ops/kernels/mil_pool.py`` computes the
same function for K = 1 without writing the (N, D) gate activations to
device memory.
"""

from __future__ import annotations

import torch

from .masked import masked_softmax


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with the operands promoted to their common type, as the
    JAX package's ``@`` does for a bf16 bag against fp32 weights."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def gated_attention_logits(x, wv, bv, wu, bu, ww, bw):
    """Per-instance attention logits. x: (..., N, L) -> (..., N, K)."""
    a_v = torch.tanh(_matmul(x, wv) + bv)
    a_u = torch.sigmoid(_matmul(x, wu) + bu)
    return _matmul(a_v * a_u, ww) + bw


def gated_attention_pool(x, wv, bv, wu, bu, ww, bw, mask=None):
    """Batched gated-attention pooling.

    x: (..., N, L); mask: (..., N) bool or None.
    Returns (M, A): pooled (..., K, L) and attention (..., K, N).
    """
    if mask is not None:
        # zero masked rows' values too: a zero attention weight alone does
        # not stop non-finite padding (0·NaN = NaN) from poisoning the
        # pooling product
        x = torch.where(mask[..., None], x, torch.zeros_like(x))
    a = gated_attention_logits(x, wv, bv, wu, bu, ww, bw)   # (..., N, K)
    a = a.transpose(-1, -2)                                 # (..., K, N)
    m = mask[..., None, :] if mask is not None else None
    A = masked_softmax(a, m, dim=-1)
    return _matmul(A, x), A                                 # (..., K, L)
