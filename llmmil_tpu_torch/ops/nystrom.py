"""Nyström attention (Xiong et al. 2021) as a plain PyTorch function.

The same math as the JAX package's ``ops/nystrom.py``, mask-aware:

    q~ , k~  = segment means of q, k over m landmark groups
    F = softmax(q k~ᵀ)        (N, m)
    A = softmax(q~ k~ᵀ)       (m, m)
    B = softmax(q~ kᵀ)        (m, N)
    out = F @ pinv(A) @ (B @ v)

with ``pinv`` the iterative Moore–Penrose approximation.  O(N·m) instead of
O(N²) for the ~15k-token pathology bags.  Every product is a plain matmul
in the operands' type (no kernel of the JAX package runs here), the
``attn1 @ pinv`` product of the factored map included.  The dynamic-int8
serving mode of the JAX package's ``attn_dot`` is not ported (ROADMAP.md,
Queue 1 item 8) and raises.
"""

from __future__ import annotations

import torch

from .masked import masked_softmax, segment_mean_landmarks

_INT8_ITEM = ("nystrom_attention(int8=True): the dynamic-int8 attention mode "
              "is not ported yet (ROADMAP.md, Queue 1 item 8: quantised "
              "serving)")


def moore_penrose_pinv(a: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Iterative Moore–Penrose pseudoinverse of (..., m, m) matrices.

    Razavi et al. iteration: z₀ = aᵀ / (‖a‖₁‖a‖∞), the norms of each
    matrix on its own; z ← ¼ z (13 I − a z (15 I − a z (7 I − a z))),
    ``iters`` times, unrolled.
    """
    abs_a = a.abs()
    col = abs_a.sum(dim=-2).amax(dim=-1)     # max column sum = ||a||_1
    row = abs_a.sum(dim=-1).amax(dim=-1)     # max row sum = ||a||_inf
    z = a.transpose(-1, -2) / (col * row).clamp_min(1e-30)[..., None, None]
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    for _ in range(iters):
        az = a @ z
        z = 0.25 * z @ (13.0 * eye - az @ (15.0 * eye
                                           - az @ (7.0 * eye - az)))
    return z


def nystrom_attention(q, k, v, num_landmarks: int = 256,
                      pinv_iterations: int = 6, mask=None,
                      return_attn: bool = False, int8: bool = False):
    """q, k, v: (B, H, N, Dh); mask: (B, N) bool or None.

    N must be divisible by ``num_landmarks`` (callers pad).  q is scaled by
    Dh^-½ before the landmark means; the first two softmaxes take no mask
    (landmarks are all valid), the third masks its keys.  Returns (out,
    attn) with out (B, H, N, Dh) and attn the factored map (left (B, H, N,
    m), right (B, H, m, N)) under ``return_attn``, else None.
    """
    if int8:
        raise NotImplementedError(_INT8_ITEM)
    dh = q.shape[-1]
    q = q * dh ** -0.5

    lm_mask = sm_mask = None
    if mask is not None:
        sm_mask = mask[:, None, None, :]            # (B,1,1,N) over keys
        lm_mask = mask[:, None, :]                   # (B,1,N) landmark means

    q_l = segment_mean_landmarks(q, num_landmarks, lm_mask)    # (B,H,m,Dh)
    k_l = segment_mean_landmarks(k, num_landmarks, lm_mask)

    sim1 = q @ k_l.transpose(-1, -2)                # (B,H,N,m)
    sim2 = q_l @ k_l.transpose(-1, -2)              # (B,H,m,m)
    sim3 = q_l @ k.transpose(-1, -2)                # (B,H,m,N)

    attn1 = masked_softmax(sim1, None)
    attn2 = masked_softmax(sim2, None)
    attn3 = masked_softmax(sim3, sm_mask)

    attn2_inv = moore_penrose_pinv(attn2, pinv_iterations)
    left = attn1 @ attn2_inv                        # (B,H,N,m)
    out = left @ (attn3 @ v)                        # (B,H,N,Dh)
    if return_attn:
        # the full product is (B,H,N,N), ~2 TiB at a 16k-row bag: rows are
        # rebuilt on demand (nystrom_attn_rows / nystrom_attn_full)
        return out, (left, attn3)
    return out, None


def nystrom_attn_rows(factors, rows) -> torch.Tensor:
    """Selected rows (B, H, len(rows), N) of the factored map (left, right),
    e.g. ``rows=0`` for the cls token's saliency row."""
    left, right = factors
    idx = torch.atleast_1d(torch.as_tensor(rows, device=left.device))
    return left[:, :, idx, :] @ right


def nystrom_attn_full(factors) -> torch.Tensor:
    """The full (B, H, N, N) map — small N only (tests)."""
    left, right = factors
    return left @ right
