"""3×3 stride-1 SAME convolution of an NHWC tensor: wrapper and plain version.

    y[n, h, w, :] = Σ_{dr, dc} x[n, h + dr - 1, w + dc - 1, :] @ k[dr, dc]

with x read as zero outside the image.  The kernel (``csrc/conv3x3.cu``)
replaces the Pallas TPU kernel ``_fwd_kernel`` of
``llmmil_tpu/ops/pallas/conv3x3.py`` (``_conv_fwd(mode="taps")``), which
MC3 layer1's depth-folded convolutions reach through
``models/ct_mc3.py::DepthFoldedConv`` when ``ct_conv_backend="pallas"``.

What bounds it on an H100: ``2·N·H·W·9·C·F`` operations against x read once
and y written once.  At the trunk's shape, (160, 128, 128, 192) → 64 in
bf16, that is 5.8e11 operations (0.59 ms at the 989 TFLOP/s bf16 peak)
against 1.34 GB (0.40 ms at 3.35 TB/s): operations; an fp32 tensor runs on
the fp32 pipes and operations bound it by far.  What the design does about
it: the TPU kernel keeps a whole padded image in fast memory, which an SM's
227 KB cannot hold, so a block stages an 18 × 18 pixel halo patch of 16
channels at a time beside the matching slab of k, through a ring of three
stages filled by ``cp.async``, and runs the nine taps as shifted
``ldmatrix`` windows of that patch through ``mma.sync`` (bf16, fp32
accumulation); the grid is persistent, two blocks an SM.  The SAME padding
and every ragged edge are the kernel's: nothing is padded or copied in device
memory.  Still open: ``wgmma`` and TMA, and k and the halos shared across
blocks instead of read again from L2 by every tile.

Numerics, as the TPU kernel: k cast to x's type, products in that type,
fp32 accumulation, y in x's type.

The TPU kernel has backward kernels (the input gradient is the forward on
the rotated kernel, the weight gradient a kernel of its own); neither is
ported yet, so a CUDA tensor that requires grad raises instead of
differentiating through the plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BACKWARD_ITEM = (
    "conv3x3: the backward kernels are not ported yet (ROADMAP.md, Queue 2 "
    "rows 2 (input gradient) and 5 (weight gradient)); a CUDA tensor that "
    "requires grad cannot go through the forward kernel")


def _check_shapes(x, w):
    if x.dim() != 4:
        raise ValueError(f"conv3x3: x must be (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) \
            or w.shape[2] != x.shape[-1]:
        raise ValueError(f"conv3x3 needs 3×3 kernels, got {tuple(w.shape)} "
                         f"for x {tuple(x.shape)}")


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


class _Launcher:
    """The loaded library's entry point, with its argument types."""

    def __init__(self):
        lib = load_library("conv3x3")
        lib.conv3x3_fwd.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.conv3x3_fwd.restype = ctypes.c_int
        self.fwd = lib.conv3x3_fwd


def _conv3x3_cuda(x, w):
    """Check the operands, launch the kernel on the current stream."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv3x3: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if w.device != x.device:
        raise ValueError(f"conv3x3: w lies on {w.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("conv3x3: x must be contiguous (N, H, W, C)")
    n, h, wd, c = x.shape
    f = w.shape[-1]
    # k in x's type, as the TPU kernel casts it; it is small, so a strided
    # or fp32 one is copied (cast and laid out in one pass), not refused
    k = torch.empty((3, 3, c, f), dtype=x.dtype, device=x.device).copy_(w)
    y = torch.empty((n, h, wd, f), dtype=x.dtype, device=x.device)
    for name, t in (("x", x), ("w", k), ("y", y)):
        if t.data_ptr() % 16:
            raise ValueError(f"conv3x3: {name} must be 16-byte aligned")

    launcher = conv3x3.launcher
    if launcher is None:
        launcher = conv3x3.launcher = _Launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launcher.fwd(x.data_ptr(), k.data_ptr(), y.data_ptr(), n, h,
                           wd, c, f, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"conv3x3: kernel launch failed with CUDA error "
                           f"{err} for x {tuple(x.shape)} -> {f}, {x.dtype}")
    conv3x3.launches += 1
    return y


def conv3x3(x, w):
    """3×3 stride-1 SAME NHWC convolution.

    x: (N, H, W, C) float32 or bfloat16; w: (3, 3, C, F); returns
    (N, H, W, F) in x's type.  A CUDA tensor launches the kernel or raises;
    a CPU tensor takes the plain version.  ``conv3x3.launches`` counts the
    kernel launches.
    """
    _check_shapes(x, w)
    if x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise NotImplementedError(_BACKWARD_ITEM)
        return _conv3x3_cuda(x, w)
    return conv3x3_plain(x, w)


conv3x3.launches = 0       # one per kernel launch, nowhere else
conv3x3.launcher = None    # the loaded library, set at the first launch
