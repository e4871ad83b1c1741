"""3×3 stride-1 SAME convolution of an NHWC tensor and its two gradients:
wrappers, plain versions and the ``torch.autograd.Function`` that joins them.

    y[n, h, w, :]   = Σ_{dr, dc} x[n, h + dr - 1, w + dc - 1, :] @ k[dr, dc]
    dx              = the same convolution of g with k rotated by 180° and its
                      channel axes swapped
    dk[dr, dc]      = Σ_{n, h, w} x[n, h + dr - 1, w + dc - 1, :]ᵀ · g[n, h, w, :]

with x read as zero outside the image.  The kernels replace the Pallas TPU
kernels of ``llmmil_tpu/ops/pallas/conv3x3.py`` that MC3 layer1's
depth-folded convolutions reach through ``models/ct_mc3.py::DepthFoldedConv``
when ``ct_conv_backend="pallas"``:

- forward and input gradient: ``csrc/conv3x3.cu`` replaces ``_fwd_kernel``
  (``_conv_fwd(mode="taps")``); the input gradient is that same kernel on
  the rotated, transposed kernel, as the JAX package's custom VJP runs it;
- weight gradient: ``csrc/conv3x3_wgrad.cu`` replaces ``_wgrad_kernel``
  (``_conv_wgrad(mode="taps")``).

What bounds them on an H100: ``2·N·H·W·9·C·F`` operations against x (or g)
read once and the output written once.  At the trunk's shape, (160, 128,
128, 192) → 64 in bf16, each is 5.8e11 operations (0.59 ms at the 989 TFLOP/s
bf16 peak) against 1.34 GB (0.40 ms at 3.35 TB/s): operations; an fp32 tensor
runs on the fp32 pipes and operations bound it by far.  What the designs do
about it is in the two sources: the forward stages an 18 × 18 halo patch of
16 channels at a time and runs the nine taps as shifted ``ldmatrix`` windows
through ``mma.sync``; the weight gradient splits the 2.6M-pixel reduction
over the grid, keeps each block's (tap, 32 channels) × 64 partial in
registers, stages the same kind of halo patch beside the tile of g, and adds
the partials in a second pass in a fixed order (no float atomics, so two runs
give the same bits).  Nothing is padded or copied in device memory.

Numerics, as the TPU kernels: the forward casts k to x's type, multiplies in
that type and accumulates in fp32, y in x's type; the backward casts g to
x's type before both products, dx comes out in x's type and dk in fp32, cast
to k's type (the trunk hands in a kernel already cast to the compute type, so
under bf16 the weight gradient is rounded to bf16 before autograd of that
cast carries it to the fp32 parameter).

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions, in the forward and in the backward alike.  ``conv3x3.launches``,
``conv3x3_dgrad.launches`` and ``conv3x3_wgrad.launches`` count the kernel
launches of each.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(x, w):
    if x.dim() != 4:
        raise ValueError(f"conv3x3: x must be (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[-1]:
        raise ValueError(f"conv3x3 needs 3×3 kernels, got {tuple(w.shape)} "
                         f"for x {tuple(x.shape)}")


def _check_pair(x, dy):
    if x.dim() != 4 or dy.dim() != 4 or tuple(x.shape[:3]) \
            != tuple(dy.shape[:3]):
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} and dy "
                         f"{tuple(dy.shape)} must be (N, H, W, C) and "
                         f"(N, H, W, F)")


def _rotated(w):
    """k rotated by 180° in its two spatial axes, channel axes swapped:
    (3, 3, C, F) → (3, 3, F, C)."""
    return w.flip((0, 1)).transpose(2, 3)


def conv3x3_plain(x, w):
    """Plain PyTorch version: the nine tap products one by one.

    x: (N, H, W, C); w: (3, 3, C, F); returns (N, H, W, F) in x's type.  Each
    tap is a shifted window of the zero-padded tensor times its (C, F)
    kernel.  The operands are rounded to x's type and multiplied in fp32,
    which for bf16 values gives the exact products, and the nine results
    are summed in fp32.  Differentiable by autograd.
    """
    _check_shapes(x, w)
    n, h, wd, _ = x.shape
    wt = w.to(x.dtype).float()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    acc = None
    for dr in range(3):
        for dc in range(3):
            tap = xp[:, dr:dr + h, dc:dc + wd, :].float() @ wt[dr, dc]
            acc = tap if acc is None else acc + tap
    return acc.to(x.dtype)


def conv3x3_dgrad_plain(g, w):
    """Plain input gradient: ``conv3x3_plain`` of g (N, H, W, F) on the
    rotated, transposed kernel; (N, H, W, C) in g's type."""
    return conv3x3_plain(g, _rotated(w))


def conv3x3_wgrad_plain(x, dy, acc_dtype=torch.float32):
    """Plain weight gradient: nine products of shifted windows, summed.

    x: (N, H, W, C); dy: (N, H, W, F), rounded to x's type first; returns
    (3, 3, C, F) float32.  Each tap is (pixels × C)ᵀ · (pixels × F) of the
    zero-padded x's window and dy, computed in ``acc_dtype`` (float64 gives a
    reference whose own rounding is far below the kernel's)."""
    _check_pair(x, dy)
    n, h, wd, c = x.shape
    f = dy.shape[-1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).to(acc_dtype)
    dyf = dy.to(x.dtype).to(acc_dtype).reshape(-1, f)
    taps = [xp[:, dr:dr + h, dc:dc + wd, :].reshape(-1, c).t() @ dyf
            for dr in range(3) for dc in range(3)]
    return torch.stack(taps).reshape(3, 3, c, f).float()


class _Launcher:
    """The loaded libraries' entry points, with their argument types."""

    def __init__(self):
        lib = load_library("conv3x3")
        lib.conv3x3_fwd.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.conv3x3_fwd.restype = ctypes.c_int
        self.fwd = lib.conv3x3_fwd
        wlib = load_library("conv3x3_wgrad")
        wlib.conv3x3_wgrad_splits.argtypes = [ctypes.c_int] * 6 + \
            [ctypes.POINTER(ctypes.c_int)]
        wlib.conv3x3_wgrad_splits.restype = ctypes.c_int
        wlib.conv3x3_wgrad.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p]
        wlib.conv3x3_wgrad.restype = ctypes.c_int
        self.wgrad_splits = wlib.conv3x3_wgrad_splits
        self.wgrad = wlib.conv3x3_wgrad
        self.splits = {}       # (device, shape, dtype) → pixel ranges


def _launcher():
    if conv3x3.launcher is None:
        conv3x3.launcher = _Launcher()
    return conv3x3.launcher


def _check_cuda(name, *tensors):
    x = tensors[0]
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: tensors must be float32 or bfloat16, got "
                        f"{x.dtype}")
    for t in tensors[1:]:
        if t.device != x.device:
            raise ValueError(f"{name}: operands lie on {t.device} and "
                             f"{x.device}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous NHWC")


def _check_aligned(name, **tensors):
    for key, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def _launch_fwd(x, w, counter):
    """Check the operands, launch the forward kernel on the current stream;
    ``counter`` is the wrapper whose launches this counts."""
    name = counter.__name__
    _check_cuda(name, x)
    if w.device != x.device:
        raise ValueError(f"{name}: w lies on {w.device}, x on {x.device}")
    n, h, wd, c = x.shape
    f = w.shape[-1]
    # k in x's type, as the TPU kernel casts it; it is small, so a strided
    # or fp32 one is copied (cast and laid out in one pass), not refused
    k = torch.empty((3, 3, c, f), dtype=x.dtype, device=x.device).copy_(w)
    y = torch.empty((n, h, wd, f), dtype=x.dtype, device=x.device)
    _check_aligned(name, x=x, w=k, y=y)
    launcher = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launcher.fwd(x.data_ptr(), k.data_ptr(), y.data_ptr(), n, h,
                           wd, c, f, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} for x {tuple(x.shape)} -> {f}, {x.dtype}")
    counter.launches += 1
    return y


def _launch_wgrad(x, dy):
    """Check the operands, launch the weight-gradient kernels (partials and
    their fixed-order sum) on the current stream."""
    _check_cuda("conv3x3_wgrad", x, dy)
    if dy.dtype != x.dtype:
        raise TypeError(f"conv3x3_wgrad: dy must be in x's type {x.dtype}, "
                        f"got {dy.dtype}")
    n, h, wd, c = x.shape
    f = dy.shape[-1]
    code = _DTYPE_CODE[x.dtype]
    launcher = _launcher()
    with torch.cuda.device(x.device):
        key = (x.device, n, h, wd, c, f, code)
        if key not in launcher.splits:
            out = ctypes.c_int(0)
            err = launcher.wgrad_splits(n, h, wd, c, f, code,
                                        ctypes.byref(out))
            if err != 0:
                raise RuntimeError(f"conv3x3_wgrad: planning failed with CUDA "
                                   f"error {err} for x {tuple(x.shape)}")
            launcher.splits[key] = out.value
        splits = launcher.splits[key]
        ws = torch.empty(splits * 9 * c * f, dtype=torch.float32,
                         device=x.device)
        dw = torch.empty((3, 3, c, f), dtype=torch.float32, device=x.device)
        _check_aligned("conv3x3_wgrad", x=x, dy=dy)
        stream = torch.cuda.current_stream().cuda_stream
        err = launcher.wgrad(x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                             dw.data_ptr(), n, h, wd, c, f, splits, code,
                             stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad: kernel launch failed with CUDA "
                           f"error {err} for x {tuple(x.shape)}, dy "
                           f"{tuple(dy.shape)}, {x.dtype}")
    conv3x3_wgrad.launches += 1
    return dw


def conv3x3_dgrad(g, w):
    """Input gradient: g (N, H, W, F) with the forward's kernel w (3, 3, C,
    F) → (N, H, W, C) in g's type.  A CUDA tensor launches the forward
    kernel on the rotated, transposed kernel (counted in
    ``conv3x3_dgrad.launches``) or raises; a CPU tensor takes the plain
    version."""
    _check_shapes(g, _rotated(w))
    if g.is_cuda:
        return _launch_fwd(g, _rotated(w), conv3x3_dgrad)
    return conv3x3_dgrad_plain(g, w)


def conv3x3_wgrad(x, dy):
    """Weight gradient: x (N, H, W, C), dy (N, H, W, F) in x's type →
    (3, 3, C, F) float32.  A CUDA tensor launches the kernels or raises; a
    CPU tensor takes the plain version."""
    _check_pair(x, dy)
    if x.is_cuda:
        return _launch_wgrad(x, dy)
    return conv3x3_wgrad_plain(x, dy)


class _Conv3x3Function(torch.autograd.Function):
    """The forward kernel, and a backward of the two gradient kernels, as
    the JAX package's custom VJP: g is cast to x's type before both
    products, the weight gradient to the kernel's type after."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.is_cuda:
            return _launch_fwd(x, w, conv3x3)
        return conv3x3_plain(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = conv3x3_dgrad(g, w) if ctx.needs_input_grad[0] else None
        dw = conv3x3_wgrad(x, g).to(w.dtype) \
            if ctx.needs_input_grad[1] else None
        return dx, dw


def conv3x3(x, w):
    """3×3 stride-1 SAME NHWC convolution, differentiable.

    x: (N, H, W, C) float32 or bfloat16; w: (3, 3, C, F); returns
    (N, H, W, F) in x's type.  A CUDA tensor launches the kernel or raises;
    a CPU tensor takes the plain version.  Where autograd records, the
    backward runs ``conv3x3_dgrad`` and ``conv3x3_wgrad``.
    ``conv3x3.launches`` counts the forward kernel's launches.
    """
    _check_shapes(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _Conv3x3Function.apply(x, w)
    if x.is_cuda:
        return _launch_fwd(x, w, conv3x3)
    return conv3x3_plain(x, w)


conv3x3.launches = 0        # one per forward launch, nowhere else
conv3x3.launcher = None     # the loaded libraries, set at the first launch
conv3x3_dgrad.launches = 0  # one per input-gradient launch
conv3x3_wgrad.launches = 0  # one per weight-gradient launch (both kernels)
