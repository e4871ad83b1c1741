"""Fused masked gated-attention MIL pooling: wrapper and plain version.

    a_n    = w · (tanh(x_n V + bv) ⊙ σ(x_n U + bu)) + bw
    p      = masked_softmax(a)          (over the N rows of a bag)
    pooled = Σ_n p_n x_n

The kernel (``csrc/mil_pool.cu``) replaces the Pallas TPU kernel
``_mil_kernel`` of ``llmmil_tpu/ops/pallas/mil_pool.py``.

What bounds it on an H100: it does ``2·B·N·L·(2D+1) + 2·B·N·L`` operations
and must read the bag's ``B·N·L·itemsize`` bytes once.  At 8×8192×768 bf16
that is about 39 GFLOP (39 µs at the 989 TFLOP/s bf16 peak) against about
101 MB (30 µs at 3.35 TB/s): operations and bytes nearly level, operations
ahead; for fp32 bags the products run on the fp32 pipes and operations bound
it by far.  What the design does about it: the TPU kernel's one program per
bag would leave 131 of 132 SMs idle at batch 1, so the bag's rows are split
over blocks (128 rows for bf16, 64 for fp32), each with its own
(max, Σe, Σe·x) partial, and a second small kernel joins the partials
(flash-decoding style).  The gate activations never reach device memory;
bf16 products go through the tensor cores (``mma.sync`` fed by ``ldmatrix``)
with fp32 accumulation, and the K-chunks of the rows, V and U are double
buffered with ``cp.async`` so that loads overlap the products.  Still open:
each block reads V and U again from L2 and the pooling sum reads its rows a
second time; ``wgmma`` and TMA are not used yet.

Numerics: products in the bag's type with fp32 accumulation, V and U cast to
the bag's type, biases, ``w`` and the softmax in fp32, fill −1e30, an
all-masked bag gives zeros.  The softmax weights stay fp32 in the pooling
sum (the Pallas body rounds them to the bag's type first).  Masked rows
contribute nothing whatever they hold, NaN included — the plain version's
contract; the Pallas body multiplies them by zero instead.
"""

from __future__ import annotations

import ctypes

import torch

from ..masked import masked_softmax
from .build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
GATE_WIDTH = 192      # the D the kernel is compiled for


def mil_pool_plain(x, mask, wv, bv, wu, bu, ww, bw):
    """Plain PyTorch version, in fp32: ``(pooled (B, L), attn (B, N))``.

    x: (B, N, L); mask: (B, N) bool; wv, wu: (L, D); bv, bu: (D,);
    ww: (D, 1); bw: (1,).
    """
    xm = torch.where(mask[..., None], x, torch.zeros_like(x)).float()
    a = (torch.tanh(xm @ wv.float() + bv)
         * torch.sigmoid(xm @ wu.float() + bu)) @ ww.float() + bw
    p = masked_softmax(a[..., 0], mask, dim=-1)               # (B, N)
    pooled = torch.einsum("bn,bnl->bl", p, xm)
    return pooled, p


class _Launcher:
    """The loaded library's entry points, with their argument types."""

    def __init__(self):
        lib = load_library("mil_pool")
        lib.mil_pool_tile_rows.argtypes = [ctypes.c_int]
        lib.mil_pool_tile_rows.restype = ctypes.c_int
        lib.mil_pool_fwd.argtypes = [ctypes.c_void_p] * 12 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.mil_pool_fwd.restype = ctypes.c_int
        self.fwd = lib.mil_pool_fwd
        # rows of a bag that one block takes, by the bag's type
        self.tile_rows = {dt: int(lib.mil_pool_tile_rows(code))
                          for dt, code in _DTYPE_CODE.items()}


def _check(name, t, dtype, shape, device, align=4):
    if t.device != device:
        raise ValueError(f"mil_pool: {name} lies on {t.device}, the bag on "
                         f"{device}")
    if t.dtype != dtype:
        raise TypeError(f"mil_pool: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"mil_pool: {name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"mil_pool: {name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"mil_pool: {name} must be {align}-byte aligned")


def _mil_pool_cuda(x, mask, wv, bv, wu, bu, ww, bw):
    """Check the operands, launch the kernel on the current stream."""
    if x.dim() != 3:
        raise ValueError(f"mil_pool: x must be (B, N, L), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"mil_pool: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    b, n, l = x.shape
    d = wv.shape[-1]
    if d != GATE_WIDTH or l % 64 or n < 1 or not 1 <= b <= 65535:
        raise ValueError(
            f"mil_pool: the kernel takes D == {GATE_WIDTH}, L a multiple of "
            f"64, N >= 1 and 1 <= B <= 65535; got B={b}, N={n}, L={l}, D={d}")
    dev = x.device
    # the kernel loads the bag and the weights 16 bytes a thread
    _check("x", x, x.dtype, (b, n, l), dev, align=16)
    _check("mask", mask, torch.bool, (b, n), dev, align=1)
    # V and U in the bag's type, as the TPU kernel casts them; they are
    # small, so a transposed or fp32 one is copied (cast and laid out in
    # one pass) rather than refused
    wv = torch.empty((l, d), dtype=x.dtype, device=dev).copy_(wv)
    wu = torch.empty((l, d), dtype=x.dtype, device=dev).copy_(wu)
    ww = ww.reshape(-1)
    for name, t, shape in (("wv", wv, (l, d)), ("wu", wu, (l, d))):
        _check(name, t, x.dtype, shape, dev, align=16)
    for name, t, shape in (("bv", bv, (d,)), ("bu", bu, (d,)),
                           ("ww", ww, (d,)), ("bw", bw, (1,))):
        _check(name, t, torch.float32, shape, dev)

    k = mil_pool.launcher
    if k is None:
        k = mil_pool.launcher = _Launcher()
    n_tiles = -(-n // k.tile_rows[x.dtype])
    pooled = torch.empty((b, l), dtype=torch.float32, device=dev)
    attn = torch.empty((b, n), dtype=torch.float32, device=dev)
    part_ms = torch.empty((b, n_tiles, 2), dtype=torch.float32, device=dev)
    part_acc = torch.empty((b, n_tiles, l), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = k.fwd(x.data_ptr(), mask.data_ptr(), wv.data_ptr(),
                    wu.data_ptr(), bv.data_ptr(), bu.data_ptr(),
                    ww.data_ptr(), bw.data_ptr(), pooled.data_ptr(),
                    attn.data_ptr(), part_ms.data_ptr(), part_acc.data_ptr(),
                    b, n, l, d, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mil_pool: kernel launch failed with CUDA error "
                           f"{err} for B={b}, N={n}, L={l}, {x.dtype}")
    mil_pool.launches += 1
    return pooled, attn


class _MilPoolFunction(torch.autograd.Function):
    """Kernel forward; the backward recomputes through autograd of the
    plain version, as the JAX package's custom VJP does (it has no backward
    kernel either)."""

    @staticmethod
    def forward(ctx, x, mask, wv, bv, wu, bu, ww, bw):
        ctx.save_for_backward(x, mask, wv, bv, wu, bu, ww, bw)
        return _mil_pool_cuda(x, mask, wv, bv, wu, bu, ww, bw)

    @staticmethod
    def backward(ctx, g_pooled, g_attn):
        x, mask, *params = ctx.saved_tensors
        inputs = [x, *params]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(t.is_floating_point())
                      for t in inputs]
            pooled, attn = mil_pool_plain(leaves[0], mask, *leaves[1:])
            wanted = [i for i, need in enumerate(
                ctx.needs_input_grad[:1] + ctx.needs_input_grad[2:]) if need]
            grads = torch.autograd.grad(
                [pooled, attn], [leaves[i] for i in wanted],
                [g_pooled, g_attn], allow_unused=True)
        out = [None] * len(inputs)
        for i, g in zip(wanted, grads):
            out[i] = None if g is None else g.to(inputs[i].dtype)
        return (out[0], None, *out[1:])


def mil_pool(x, mask, wv, bv, wu, bu, ww, bw):
    """Fused masked gated-attention pooling.

    x: (B, N, L) float32 or bfloat16; mask: (B, N) bool; returns
    ``(pooled (B, L), attn (B, N))`` in float32.  A CUDA bag launches the
    kernel or raises; a CPU bag takes the plain version.  ``mil_pool.launches``
    counts the kernel launches.
    """
    if x.is_cuda:
        return _MilPoolFunction.apply(x, mask, wv, bv, wu, bu, ww, bw)
    return mil_pool_plain(x, mask, wv, bv, wu, bu, ww, bw)


mil_pool.launches = 0       # one per kernel launch, nowhere else
mil_pool.launcher = None    # the loaded library, set at the first launch
