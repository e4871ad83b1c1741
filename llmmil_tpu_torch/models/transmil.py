"""TransMIL: Nyström-attention MIL over long instance bags.

The JAX package's ``models/transmil.py`` (``NystromSelfAttention``,
``TransLayer``, ``PPEG``, ``TransMIL``) under the reference's ``state_dict``
names: ``_fc1.0``, ``cls_token``, ``layer{1,2}.norm``, ``layer{1,2}.attn.
to_qkv`` (no bias), ``layer{1,2}.attn.to_out.0``, ``layer{1,2}.attn.
res_conv``, ``pos_layer.proj / proj1 / proj2``, ``norm``.  Batched and
mask-aware; ``mask=None`` reproduces the reference's unmasked numerics,
front-padded rows included.  Masked rows are zeroed with ``torch.where``
(never by a multiply), so whatever they hold, NaN included, stays out.
Parameters are fp32; ``Dense`` and the convolutions cast them to the compute
type where they are used, ``LayerNorm32`` computes and returns fp32, as flax
does.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.nystrom import nystrom_attention
from .layers import Dense, LayerNorm32, normal_

_MOE_ITEM = ("a TransMIL with a routed-FFN block (moe_experts > 0) is not "
             "ported yet (ROADMAP.md, Queue 1 item 5: the other trunks and "
             "heads, moe.py)")


class _ResConv(torch.autograd.Function):
    """``res_conv``: the (heads, 1, k, 1) depthwise convolution over the
    token axis of v (B, heads, N, Dh), with the weight gradient written out.

    The forward and the input gradient are ``F.conv2d`` and its transpose.
    The weight gradient is not left to the library: oneDNN's depthwise
    weight gradient on the CPU is ~6 % of its max off an fp64 evaluation at
    a padded length of 256 (taps 17-31).  Here it is what the JAX package's
    shift-and-add form differentiates to, k reductions over shifted slices
    of the zero-padded values:

        dW[h, t] = Σ_{b, n, d} v_pad[b, h, n + t, d] · g[b, h, n, d]

    each in fp32 (the products of bf16 operands are exact there), cast to
    the weight's type.
    """

    @staticmethod
    def forward(ctx, v, w):
        ctx.save_for_backward(v, w)
        return F.conv2d(v, w, padding=(w.shape[2] // 2, 0),
                        groups=v.shape[1])

    @staticmethod
    def backward(ctx, g):
        v, w = ctx.saved_tensors
        heads, taps, pad = v.shape[1], w.shape[2], w.shape[2] // 2
        dv = dw = None
        if ctx.needs_input_grad[0]:
            dv = F.conv_transpose2d(g, w, padding=(pad, 0), groups=heads)
        if ctx.needs_input_grad[1]:
            n = g.shape[2]
            vp = F.pad(v.float(), (0, 0, pad, pad))
            gf = g.float()
            dw = torch.stack([(vp[:, :, t:t + n] * gf).sum((0, 2, 3))
                              for t in range(taps)], dim=-1)
            dw = dw.reshape(w.shape).to(w.dtype)
        return dv, dw


class NystromSelfAttention(nn.Module):
    """Self-attention with the Nyström approximation and a residual
    depthwise convolution over the values (lucidrains' ``NystromAttention``):
    biasless qkv projection, front padding to a multiple of the landmark
    count (the padded rows take part when ``mask=None``, as in the
    reference), the Nyström product, ``res_conv`` over the token axis per
    head, output projection."""

    def __init__(self, dim: int = 512, heads: int = 8, dim_head: int = 64,
                 num_landmarks: int = 256, pinv_iterations: int = 6,
                 residual: bool = True, residual_conv_kernel: int = 33,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.num_landmarks = num_landmarks
        self.pinv_iterations = pinv_iterations
        self.compute_dtype = dtype
        inner = heads * dim_head
        self.to_qkv = Dense(dim, inner * 3, dtype, bias=False)
        self.to_out = nn.Sequential(Dense(inner, dim, dtype),
                                    nn.Dropout(dropout))
        self.res_conv = None
        if residual:
            self.res_conv = nn.Conv2d(
                heads, heads, (residual_conv_kernel, 1),
                padding=(residual_conv_kernel // 2, 0), groups=heads,
                bias=False)

    def init_weights(self, generator) -> None:
        """``res_conv`` as flax's LeCun-normal initialiser draws its
        (heads, 1, k, 1) parameter: fan-in k · heads."""
        if self.res_conv is not None:
            k = self.res_conv.weight.shape[2]
            normal_(self.res_conv.weight, 1.0 / math.sqrt(k * self.heads),
                    generator)

    def forward(self, x, mask=None, return_attn: bool = False):
        b, n, _ = x.shape
        h, dh, m = self.heads, self.dim_head, self.num_landmarks
        pad = (m - n % m) % m
        if pad:                       # front padding to whole landmarks
            x = F.pad(x, (0, 0, pad, 0))
            if mask is not None:
                mask = F.pad(mask, (pad, 0), value=False)

        q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        q, k, v = (t.reshape(b, -1, h, dh).transpose(1, 2) for t in (q, k, v))
        if mask is not None:
            mv = mask[:, None, :, None]
            q, k, v = (torch.where(mv, t, 0.0) for t in (q, k, v))

        out, attn = nystrom_attention(
            q, k, v, num_landmarks=m, pinv_iterations=self.pinv_iterations,
            mask=mask, return_attn=return_attn)
        out = out.transpose(1, 2).reshape(b, -1, h * dh)
        if self.res_conv is not None:
            # the (heads, 1, k, 1) depthwise convolution over the token axis
            # of (B, H, N, Dh): what the JAX package computes as k shifted
            # multiply-adds
            dt = self.compute_dtype
            res = _ResConv.apply(v.to(dt), self.res_conv.weight.to(dt))
            out = out + res.transpose(1, 2).reshape(b, -1, h * dh)
        out = self.to_out(out)[:, -n:]          # drop the front padding
        if attn is not None:
            left, right = attn
            attn = (left[:, :, -n:, :], right[:, :, :, -n:])
        return out, attn


class TransLayer(nn.Module):
    """Pre-norm Nyström block with a residual."""

    def __init__(self, dim: int = 512, dtype: torch.dtype = torch.float32,
                 pinv_iterations: int = 6):
        super().__init__()
        self.norm = LayerNorm32(dim)
        self.attn = NystromSelfAttention(
            dim=dim, heads=8, dim_head=dim // 8, num_landmarks=dim // 2,
            pinv_iterations=pinv_iterations, residual=True, dropout=0.1,
            dtype=dtype)

    def forward(self, x, mask=None, return_attn: bool = False):
        y, attn = self.attn(self.norm(x), mask, return_attn)
        return x + y, attn


class PPEG(nn.Module):
    """Pyramid positional-encoding generator: three depthwise 2-D
    convolutions (7, 5, 3; SAME, with bias) of the √N × √N token grid plus
    the grid itself; the cls token passes untouched.  Masked tokens are
    zeroed first, so the convolutions and the identity term read the masked
    grid."""

    def __init__(self, dim: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.proj = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.proj1 = nn.Conv2d(dim, dim, 5, padding=2, groups=dim)
        self.proj2 = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def init_weights(self, generator) -> None:
        """LeCun-normal kernels (fan-in k²), zero biases, as flax's
        ``nn.Conv``."""
        for conv in (self.proj, self.proj1, self.proj2):
            normal_(conv.weight, 1.0 / conv.weight.shape[-1], generator)
            nn.init.zeros_(conv.bias)

    def forward(self, x, H: int, W: int, mask=None):
        b, _, c = x.shape
        cls_tok, feat = x[:, :1], x[:, 1:]
        if mask is not None:
            feat = torch.where(mask[:, 1:, None], feat, 0.0)
        grid = feat.reshape(b, H, W, c).permute(0, 3, 1, 2)    # NCHW view
        dt = self.compute_dtype
        out = grid
        for conv in (self.proj, self.proj1, self.proj2):
            out = out + F.conv2d(grid.to(dt), conv.weight.to(dt),
                                 conv.bias.to(dt), padding=conv.padding,
                                 groups=c)
        out = out.permute(0, 2, 3, 1).reshape(b, H * W, c)
        return torch.cat([cls_tok, out], dim=1)


class TransMIL(nn.Module):
    """fc1 → square wrap-pad → cls token → TransLayer → PPEG → TransLayer →
    LayerNorm → the cls token's embedding.

    Returns (cls embedding (B, D) in fp32, [attn of layer1, attn of
    layer2]), each attn the factored Nyström map under ``return_attn``,
    else None.  ``n_classes`` is kept for the reference's (unused in the
    forward) ``_fc2`` head's symmetry; ``moe_experts > 0`` raises.
    """

    def __init__(self, n_classes: int = 2, L: int = 768, D: int = 512,
                 dtype: torch.dtype = torch.float32, pinv_iterations: int = 6,
                 moe_experts: int = 0):
        super().__init__()
        if moe_experts:
            raise NotImplementedError(_MOE_ITEM)
        self.D = D
        self._fc1 = nn.Sequential(Dense(L, D, dtype), nn.ReLU())
        self.cls_token = nn.Parameter(torch.empty(1, 1, D))
        self.layer1 = TransLayer(D, dtype, pinv_iterations)
        self.pos_layer = PPEG(D, dtype)
        self.layer2 = TransLayer(D, dtype, pinv_iterations)
        self.norm = LayerNorm32(D)

    def init_weights(self, generator) -> None:
        normal_(self.cls_token, 1.0, generator)

    def forward(self, x, mask=None, return_attn: bool = False):
        h = self._fc1(x)
        b, n, _ = h.shape
        side = int(math.ceil(math.sqrt(n)))
        add = side * side - n
        if add:                              # wrap-around pad to a square
            h = torch.cat([h, h[:, :add]], dim=1)
            if mask is not None:
                mask = torch.cat([mask, mask[:, :add]], dim=1)
        cls = self.cls_token.to(h.dtype).expand(b, 1, self.D)
        h = torch.cat([cls, h], dim=1)
        if mask is not None:
            mask = F.pad(mask, (1, 0), value=True)

        h, attn0 = self.layer1(h, mask, return_attn)
        h = self.pos_layer(h, side, side, mask)
        h, attn1 = self.layer2(h, mask, return_attn)
        return self.norm(h)[:, 0], [attn0, attn1]
