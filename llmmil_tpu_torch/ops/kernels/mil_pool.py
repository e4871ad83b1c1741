"""Fused masked gated-attention MIL pooling: wrapper and plain version.

    a_n    = w · (tanh(x_n V + bv) ⊙ σ(x_n U + bu)) + bw
    p      = masked_softmax(a)          (over the N rows of a bag)
    pooled = Σ_n p_n x_n

The kernel (``csrc/mil_pool.cu``) replaces the Pallas TPU kernel
``_mil_kernel`` of ``llmmil_tpu/ops/pallas/mil_pool.py``.

What bounds it on an H100: it does ``2·B·N·L·(2D+1) + 2·B·N·L`` operations
on the valid rows and must read them once.  At 8×8192×768 bf16 that is
about 39 GFLOP (39 µs at the 989 TFLOP/s bf16 peak) against about 101 MB
(30 µs at 3.35 TB/s): operations, by a little; but every block must also
see all of V and U for each group of rows it takes, so the rows that one
read of the gates feeds decide the time.  What the bf16 design does about it
(the source says more): one launch a call; persistent blocks take the tiles
that hold a valid row (128 rows of a bag, or 64 where that is needed to give
every SM a tile) in contiguous runs, and skip the rest; V and U arrive packed
once as one K-major bf16 matrix; ``wgmma`` m64n192k16 products fed by TMA
from a producer thread keep V's and U's column j in one thread, so the gate
activations never leave registers; the pooling sum reads the tile again
through a second TMA ring while the next tile's products run; after one
grid-wide barrier every block joins a fixed share of the bags' tile
partials, in tile order.  fp32 bags take plain FMAs in two passes.

Numerics: products in the bag's type with fp32 accumulation, V and U rounded
to the bag's type, biases, ``w`` and the softmax in fp32 (bf16: tanh and σ
by the MUFU pipe's ``tanh.approx``, relative error ~2^-11), fill −1e30, an
all-masked bag gives zeros.  The softmax weights stay fp32 in the pooling
sum (the Pallas body rounds them to the bag's type first).  Masked rows
contribute nothing whatever they hold, NaN included — the plain version's
contract; the Pallas body multiplies them by zero instead.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict

import torch

from ..masked import masked_softmax
from .build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
GATE_WIDTH = 192      # the D the kernel is compiled for
# the largest bf16 call: the kernel keeps a bit for each of at most 65536
# tiles of 64 rows, B x ceil(N / 64)
BF16_MAX_TILES = 65536
_GATE_CACHE = 16      # V, U pairs whose kernel operands are kept


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


def pack_gates(wv, wu):
    """V and U, (L, D) each, as the bf16 kernel's B operand: one (2D, L)
    matrix, K-major, in halves of D/2 columns: rows ``D·h + i`` (i < D/2)
    are V's column ``D/2·h + i``, rows ``D·h + D/2 + i`` U's.  A product over
    half h then holds V's and U's column j in the same thread."""
    l, d = wv.shape
    v = wv.t().reshape(2, d // 2, l)
    u = wu.t().reshape(2, d // 2, l)
    return torch.stack([v, u], dim=1).reshape(2 * d, l).to(
        torch.bfloat16).contiguous()


def _gate_operands(wv, wu, dtype):
    """The kernel's gate operands for V and U in the bag's type, built once
    a version of them: bf16, ``(pack_gates(wv, wu), None)``; fp32, V and U
    contiguous.  Keyed, as ``models/ct_mc3.py`` keys its folded weights, on
    the parameters' storage, version, device and type; an in-place update
    (a training step) moves the version and so rebuilds them.  An entry
    holds V and U themselves, so their memory (and the key) cannot pass to
    another tensor while it is kept."""
    key = (wv.data_ptr(), wu.data_ptr(), wv.device, dtype, tuple(wv.shape),
           wv.stride(), wu.stride())
    version = (wv._version, wu._version)
    cache = mil_pool.gates
    hit = cache.get(key)
    if hit is not None and hit[0] == version:
        cache.move_to_end(key)
        return hit[2]
    with torch.no_grad():
        if dtype == torch.bfloat16:
            ops = (pack_gates(wv, wu), None)
        else:
            ops = (wv.to(dtype).contiguous(), wu.to(dtype).contiguous())
    cache[key] = (version, (wv, wu), ops)
    while len(cache) > _GATE_CACHE:
        cache.popitem(last=False)
    return ops


class _Launcher:
    """The loaded library's entry points, with their argument types."""

    def __init__(self, lib=None):
        lib = lib or load_library("mil_pool")
        lib.mil_pool_scratch_floats.argtypes = [ctypes.c_int] * 4
        lib.mil_pool_scratch_floats.restype = ctypes.c_longlong
        lib.mil_pool_plan.argtypes = [ctypes.c_int] * 2 + \
            [ctypes.POINTER(ctypes.c_int)] * 2
        lib.mil_pool_plan.restype = ctypes.c_int
        lib.mil_pool_fwd.argtypes = [ctypes.c_void_p] * 12 + \
            [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.mil_pool_fwd.restype = ctypes.c_int
        self.lib = lib
        self.fwd = lib.mil_pool_fwd
        self.floats = {}        # scratch floats by (B, N, L, dtype)
        self.workspace = {}     # (scratch, barrier) by (device, stream)

    def scratch(self, b, n, l, code, dev, stream):
        """Scratch and the grid barrier's two counters for a call, kept for
        its device and stream: calls on one stream run in order, so they
        can share them (the barrier leaves its counters fit for the next
        call); a call on another stream gets its own."""
        floats = self.floats.get((b, n, l, code))
        if floats is None:
            floats = self.floats[(b, n, l, code)] = int(
                self.lib.mil_pool_scratch_floats(b, n, l, code))
        key = (dev, stream)
        ws = self.workspace.get(key)
        if ws is None or ws[0].numel() < floats:
            ws = self.workspace[key] = (
                torch.empty(floats, dtype=torch.float32, device=dev),
                ws[1] if ws is not None
                else torch.zeros(2, dtype=torch.int32, device=dev))
        return ws

    def plan(self, b, n):
        """The bf16 plan of a call: rows a tile, blocks."""
        out = [ctypes.c_int(0) for _ in range(2)]
        err = self.lib.mil_pool_plan(b, n, *map(ctypes.byref, out))
        if err:
            raise RuntimeError(f"mil_pool_plan: CUDA error {err}")
        return tuple(v.value for v in out)


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
    """Check the operands, launch the kernel on the current stream.  Every
    check comes before the library is loaded."""
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
    if x.dtype == torch.bfloat16 and b * -(-n // 64) > BF16_MAX_TILES:
        raise ValueError(f"mil_pool: a bf16 call takes at most "
                         f"{BF16_MAX_TILES} tiles of 64 rows (B x ceil(N / "
                         f"64)), got B={b}, N={n}")
    dev = x.device
    # TMA reads the bag (bf16) and the fp32 path 16 bytes a thread
    _check("x", x, x.dtype, (b, n, l), dev, align=16)
    _check("mask", mask, torch.bool, (b, n), dev, align=1)
    for name, t, shape in (("wv", wv, (l, d)), ("wu", wu, (l, d))):
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"mil_pool: {name} must be {shape} on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    ww = ww.reshape(-1)
    for name, t, shape in (("bv", bv, (d,)), ("bu", bu, (d,)),
                           ("ww", ww, (d,)), ("bw", bw, (1,))):
        _check(name, t, torch.float32, shape, dev)

    # V and U in the bag's type, as the TPU kernel casts them, built once a
    # version: a steady-state call casts and copies nothing
    gv, gu = _gate_operands(wv, wu, x.dtype)
    k = mil_pool.launcher
    if k is None:
        k = mil_pool.launcher = _Launcher()
    code = _DTYPE_CODE[x.dtype]
    pooled = torch.empty((b, l), dtype=torch.float32, device=dev)
    attn = torch.empty((b, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, barrier = k.scratch(b, n, l, code, dev, stream)
    args = (x.data_ptr(), mask.data_ptr(), gv.data_ptr(),
            None if gu is None else gu.data_ptr(), bv.data_ptr(),
            bu.data_ptr(), ww.data_ptr(), bw.data_ptr(), pooled.data_ptr(),
            attn.data_ptr(), scratch.data_ptr(), barrier.data_ptr(), b, n, l,
            d, code, stream)
    if dev.index == torch.cuda.current_device():
        err = k.fwd(*args)
    else:                       # the library launches on the current device
        with torch.cuda.device(dev):
            err = k.fwd(*args)
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
    counts the calls that launch it (one launch a call).
    """
    if x.is_cuda:
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, wv, bv, wu, bu, ww, bw)):
            return _MilPoolFunction.apply(x, mask, wv, bv, wu, bu, ww, bw)
        return _mil_pool_cuda(x, mask, wv, bv, wu, bu, ww, bw)
    return mil_pool_plain(x, mask, wv, bv, wu, bu, ww, bw)


mil_pool.launches = 0       # one per kernel launch, nowhere else
mil_pool.launcher = None    # the loaded library, set at the first launch
mil_pool.gates = OrderedDict()   # the kernel's gate operands, by V and U
