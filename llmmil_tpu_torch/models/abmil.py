"""Gated-attention MIL aggregators (batched + mask-aware).

Bags are batched (B, N, L) with an optional validity mask so padded rows get
zero attention; ``mask=None`` reproduces the reference's unmasked numerics.

Two execution paths over the SAME parameters:
- plain PyTorch (``ops.mil.gated_attention_pool``);
- the fused kernel (``ops.kernels.mil_pool``) when ``use_kernel``: for a
  CUDA tensor it launches the CUDA kernel, for a CPU tensor it computes the
  kernel's plain version.  Without a mask every row is valid, so the kernel
  gets an all-true mask.

Parameters carry the reference's ``state_dict`` names (``attention_V.0``,
``attention_U.0``, ``attention_weights``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import mil_pool
from ..ops.mil import gated_attention_pool
from .layers import Dense


class ABMIL(nn.Module):
    """A = w(tanh(Vx) ⊙ σ(Ux)); M = softmax(A)ᵀ x.

    Returns (M, A): pooled (B, K, L) features and (B, K, N) attention.
    """

    def __init__(self, L: int = 768, D: int = 192, K: int = 1,
                 dropout: float = 0.5, dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False):
        super().__init__()
        if use_kernel and K != 1:
            raise ValueError("the fused mil_pool kernel is single-head "
                             f"(K == 1), got K={K}")
        self.K = K
        self.dropout = dropout
        self.compute_dtype = dtype
        self.use_kernel = use_kernel
        self.attention_V = nn.Sequential(Dense(L, D), nn.Tanh())
        self.attention_U = nn.Sequential(Dense(L, D), nn.Sigmoid())
        self.attention_weights = Dense(D, K)

    def forward(self, x, mask=None):
        dt = self.compute_dtype
        wv, bv = self.attention_V[0].weight.t(), self.attention_V[0].bias
        wu, bu = self.attention_U[0].weight.t(), self.attention_U[0].bias
        ww = self.attention_weights.weight.t()
        bw = self.attention_weights.bias
        x = F.dropout(x, self.dropout, self.training)
        if self.use_kernel:
            if mask is None:
                mask = torch.ones(x.shape[:2], dtype=torch.bool,
                                  device=x.device)
            # the kernel takes the compute dtype (bf16 on the card): its
            # gate products then run on the tensor cores
            pooled, att = mil_pool(x.to(dt).contiguous(), mask.contiguous(),
                                   wv, bv, wu, bu, ww, bw)
            return pooled[:, None, :].to(x.dtype), att[:, None, :]
        # only V is cast to the compute dtype; U, w and the biases stay
        # fp32 and promote, as in the JAX package
        return gated_attention_pool(x.to(dt), wv.to(dt), bv, wu, bu, ww, bw,
                                    mask=mask)


class ABMILv2(ABMIL):
    """ABMIL + Biopsy/Resection class scalar concat.

    ``bprc``: (B, 1) float scalar (0 = Biopsy, 1 = Resection) appended to the
    pooled feature → (B, K, L+1).
    """

    def forward(self, x, bprc, mask=None):
        pooled, att = super().forward(x, mask)
        bprc = bprc[..., None, :].to(pooled.dtype).expand(
            *pooled.shape[:-1], 1)
        return torch.cat([pooled, bprc], dim=-1), att
