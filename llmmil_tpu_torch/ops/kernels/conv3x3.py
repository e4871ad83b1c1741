"""3×3 stride-1 SAME convolution of an NHWC tensor and its two gradients:
wrappers, plain versions and the ``torch.autograd.Function`` that joins them.

    y[n, h, w, :]   = Σ_{dr, dc} x[n, h + dr - 1, w + dc - 1, :] @ k[dr, dc]
    dx              = the same convolution of g with k rotated by 180° and its
                      channel axes swapped
    dk[dr, dc]      = Σ_{n, h, w} x[n, h + dr - 1, w + dc - 1, :]ᵀ · g[n, h, w, :]

with x read as zero outside the image.  The kernels replace the Pallas TPU
kernels of ``llmmil_tpu/ops/pallas/conv3x3.py``.  As there, each of the three
products comes in modes, which compute the same function in another
arithmetic:

- ``taps`` (the model path: MC3 layer1's depth-folded convolutions reach it
  through ``models/ct_mc3.py::DepthFoldedConv`` when
  ``ct_conv_backend="pallas"``): ``csrc/conv3x3.cu`` replaces ``_fwd_kernel``
  (``_conv_fwd(mode="taps")``), nine tap products over one staged halo
  patch; the input gradient is that same kernel on the rotated, transposed
  kernel, as the JAX package's custom VJP runs it; ``csrc/conv3x3_wgrad.cu``
  replaces ``_wgrad_kernel`` (``_conv_wgrad(mode="taps")``);
- ``patch``: ``csrc/conv3x3_patch.cu`` replaces ``_fwd_patch_kernel``, one
  product with K = 9C over the im2col matrix, staged tile by tile;
- ``tout``: ``csrc/conv3x3_tout.cu`` replaces ``_tout_kernel``, the
  transposed product yᵀ (F, N·H·W) = kᵀ · patchᵀ, turned back to NHWC here;
  ``csrc/conv3x3_wgrad_tout.cu`` replaces ``_wgrad_tout_kernel``, dkᵀ (F, 9C)
  = gᵀ · patch.

``conv3x3_fwd``, ``conv3x3_dgrad`` and ``conv3x3_wgrad`` take the mode (the
counterparts of ``_conv_fwd`` and ``_conv_wgrad``); ``patch`` and ``tout``
are reached only through them (``eval/bench_conv3x3.py``), never by the
model, whose ``conv3x3`` and its ``autograd.Function`` stay on ``taps`` as
the JAX custom VJP does.  An unknown mode raises ``ValueError`` (the JAX
functions take ``taps`` for any other string).

What bounds them on an H100: ``2·N·H·W·9·C·F`` operations against x (or g)
read once and the output written once.  At the trunk's shape, (160, 128,
128, 192) → 64 in bf16, each is 5.8e11 operations (0.59 ms at the 989 TFLOP/s
bf16 peak) against 1.34 GB (0.40 ms at 3.35 TB/s): operations; an fp32 tensor
runs on the fp32 pipes and operations bound it by far.  What the designs do
about it is in the sources: the taps forward (bf16) stages a 10 × 66 halo of
16 channels at a time by TMA and runs the nine taps as shifted windows of
it through ``wgmma``, one 64-pixel row of output a product; the tout kernel
(bf16) runs the same stage with the operands' roles swapped, output
channels as M and pixels as N, and writes yᵀ; the patch kernel (bf16) has
TMA's im2col mode write explicit im2col tiles (one tap, 64 channels, a run
of pixels) into a ring of stages and runs one ``wgmma`` loop over K = 9C;
the fp32 patch and tout kernels gather the same tiles with ``cp.async``
into plain FMAs; the weight gradients split the 2.6M-pixel reduction over
the grid, keep each block's partial in registers, and add the partials in
a second pass in a fixed order (no float atomics, so two runs give the
same bits): in bf16 both are one ``wgmma`` kernel over a staged halo of 64
channels and the tile's dy (taps writes dw, tout dwᵀ; the Hopper
primitives of all five in ``csrc/conv3x3_sm90.cuh``).  Nothing is padded
or copied in device memory.

Numerics, as the TPU kernels: the forward casts k to x's type, multiplies in
that type and accumulates in fp32, y in x's type; the backward casts g to
x's type before both products, dx comes out in x's type and dk in fp32, cast
to k's type (the trunk hands in a kernel already cast to the compute type, so
under bf16 the weight gradient is rounded to bf16 before autograd of that
cast carries it to the fp32 parameter).

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions, in the forward and in the backward alike.  ``conv3x3.launches``,
``conv3x3_dgrad.launches`` and ``conv3x3_wgrad.launches`` count the taps
kernels' launches; ``conv3x3_patch.launches`` and ``conv3x3_tout.launches``
those of the patch and tout kernels (forward and input gradient alike), and
``conv3x3_wgrad_tout.launches`` those of the transposed weight gradient.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
FWD_MODES = ("taps", "patch", "tout")      # forward and input gradient
WGRAD_MODES = ("taps", "tout")             # weight gradient
# The plain patch and tout versions build the im2col matrix a group of whole
# images at a time, at most this many elements of it.
_IM2COL_CHUNK = 1 << 26


def _check_mode(name, mode, modes):
    if mode not in modes:
        raise ValueError(f"{name}: unknown mode {mode!r}; expected one of "
                         f"{modes}")


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


def im2col(x):
    """The (N·H·W, 9C) im2col matrix of x (N, H, W, C) in x's type: one row
    a pixel, columns tap-major, k = (dr·3 + dc)·C + c, as
    ``w.reshape(9C, F)`` lays them out; zeros outside the image."""
    n, h, wd, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dr:dr + h, dc:dc + wd, :]
                      for dr in range(3) for dc in range(3)],
                     dim=-1).reshape(-1, 9 * c)


def _image_groups(x, cols):
    """Slices of whole images whose im2col matrices hold at most
    ``_IM2COL_CHUNK`` elements each (at least one image)."""
    n, h, wd = x.shape[:3]
    per = max(1, _IM2COL_CHUNK // max(1, h * wd * cols))
    return [slice(i, i + per) for i in range(0, n, per)]


def conv3x3_patch_plain(x, w):
    """Plain version of the patch mode: the im2col matrix in x's type times
    ``w.reshape(9C, F)`` cast to x's type, one fp32 product (exact products
    for bf16 values, fp32 sums); (N, H, W, F) in x's type."""
    _check_shapes(x, w)
    n, h, wd, c = x.shape
    f = w.shape[-1]
    wf = w.to(x.dtype).reshape(9 * c, f).float()
    return torch.cat([(im2col(x[s]).float() @ wf).to(x.dtype)
                      for s in _image_groups(x, 9 * c)]).reshape(n, h, wd, f)


def conv3x3_tout_plain(x, w):
    """Plain version of the tout mode: yᵀ (F, N·H·W) = wᵀ · patchᵀ, one fp32
    product rounded to x's type, then transposed back to (N, H, W, F)."""
    _check_shapes(x, w)
    n, h, wd, c = x.shape
    f = w.shape[-1]
    wt = w.to(x.dtype).reshape(9 * c, f).float().t()
    yt = torch.cat([(wt @ im2col(x[s]).float().t()).to(x.dtype)
                    for s in _image_groups(x, 9 * c)], dim=1)
    return yt.reshape(f, n, h, wd).permute(1, 2, 3, 0).contiguous()


def conv3x3_wgrad_tout_plain(x, dy, acc_dtype=torch.float32):
    """Plain version of the tout weight gradient: dwᵀ (F, 9C) = dyᵀ · patch
    in ``acc_dtype`` (dy rounded to x's type first), summed over groups of
    images, returned as ``dwt.T.reshape(3, 3, C, F)`` float32."""
    _check_pair(x, dy)
    c, f = x.shape[-1], dy.shape[-1]
    dwt = torch.zeros((f, 9 * c), dtype=acc_dtype, device=x.device)
    for s in _image_groups(x, 9 * c):
        dyf = dy[s].to(x.dtype).to(acc_dtype).reshape(-1, f)
        dwt += dyf.t() @ im2col(x[s]).to(acc_dtype)
    return dwt.t().reshape(3, 3, c, f).float()


class _Launcher:
    """The libraries' entry points with their argument types, each library
    loaded (and built) at the first launch of one of its kernels."""

    _FWD = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    _SPLITS = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    _WGRAD = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    ENTRIES = {            # C function: (library, argument types)
        "conv3x3_fwd": ("conv3x3", _FWD),
        "conv3x3_patch_fwd": ("conv3x3_patch", _FWD),
        "conv3x3_tout_fwd": ("conv3x3_tout", _FWD),
        "conv3x3_wgrad_splits": ("conv3x3_wgrad", _SPLITS),
        "conv3x3_wgrad": ("conv3x3_wgrad", _WGRAD),
        "conv3x3_wgrad_tout_splits": ("conv3x3_wgrad_tout", _SPLITS),
        "conv3x3_wgrad_tout": ("conv3x3_wgrad_tout", _WGRAD),
    }

    def __init__(self):
        self.fns = {}
        self.splits = {}       # (entry, device, shape, dtype) → pixel ranges

    def __getitem__(self, entry):
        if entry not in self.fns:
            library, argtypes = self.ENTRIES[entry]
            fn = getattr(load_library(library), entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            self.fns[entry] = fn
        return self.fns[entry]


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


_FWD_ENTRY = {"taps": "conv3x3_fwd", "patch": "conv3x3_patch_fwd",
              "tout": "conv3x3_tout_fwd"}


def _launch_fwd(x, w, counter, mode="taps"):
    """Check the operands, launch the forward kernel of ``mode`` on the
    current stream; ``counter`` is the wrapper whose launches this counts.
    Returns the kernel's output: y (N, H, W, F), or for ``tout`` yᵀ (F,
    N·H·W)."""
    name = counter.__name__
    _check_cuda(name, x)
    if w.device != x.device:
        raise ValueError(f"{name}: w lies on {w.device}, x on {x.device}")
    n, h, wd, c = x.shape
    f = w.shape[-1]
    # k in x's type, as the TPU kernel casts it; it is small, so a strided
    # or fp32 one is copied (cast and laid out in one pass), not refused
    k = torch.empty((3, 3, c, f), dtype=x.dtype, device=x.device).copy_(w)
    shape = (f, n * h * wd) if mode == "tout" else (n, h, wd, f)
    y = torch.empty(shape, dtype=x.dtype, device=x.device)
    _check_aligned(name, x=x, w=k, y=y)
    launcher = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launcher[_FWD_ENTRY[mode]](
            x.data_ptr(), k.data_ptr(), y.data_ptr(), n, h, wd, c, f,
            _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} for x {tuple(x.shape)} -> {f}, {x.dtype}")
    counter.launches += 1
    return y


def _launch_wgrad(x, dy, mode="taps"):
    """Check the operands, launch the weight-gradient kernels of ``mode``
    (partials and their fixed-order sum) on the current stream, counted in
    that mode's wrapper.  The tout kernels write dwᵀ (F, 9C), turned into
    (3, 3, C, F) here."""
    counter = conv3x3_wgrad if mode == "taps" else conv3x3_wgrad_tout
    name = counter.__name__
    _check_cuda(name, x, dy)
    if dy.dtype != x.dtype:
        raise TypeError(f"{name}: dy must be in x's type {x.dtype}, got "
                        f"{dy.dtype}")
    n, h, wd, c = x.shape
    f = dy.shape[-1]
    code = _DTYPE_CODE[x.dtype]
    entry = "conv3x3_wgrad" if mode == "taps" else "conv3x3_wgrad_tout"
    launcher = _launcher()
    with torch.cuda.device(x.device):
        key = (entry, x.device, n, h, wd, c, f, code)
        if key not in launcher.splits:
            out = ctypes.c_int(0)
            err = launcher[entry + "_splits"](n, h, wd, c, f, code,
                                              ctypes.byref(out))
            if err != 0:
                raise RuntimeError(f"{name}: planning failed with CUDA error "
                                   f"{err} for x {tuple(x.shape)}")
            launcher.splits[key] = out.value
        splits = launcher.splits[key]
        ws = torch.empty(splits * 9 * c * f, dtype=torch.float32,
                         device=x.device)
        shape = (f, 9 * c) if mode == "tout" else (3, 3, c, f)
        dw = torch.empty(shape, dtype=torch.float32, device=x.device)
        _check_aligned(name, x=x, dy=dy)
        stream = torch.cuda.current_stream().cuda_stream
        err = launcher[entry](x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                              dw.data_ptr(), n, h, wd, c, f, splits, code,
                              stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err} for x {tuple(x.shape)}, dy "
                           f"{tuple(dy.shape)}, {x.dtype}")
    counter.launches += 1
    if mode == "tout":
        dw = dw.t().reshape(3, 3, c, f)
    return dw


def conv3x3_patch(x, w):
    """The patch mode's forward: x (N, H, W, C), w (3, 3, C, F) → (N, H, W,
    F) in x's type.  A CUDA tensor launches ``csrc/conv3x3_patch.cu`` or
    raises; a CPU tensor takes the plain version."""
    _check_shapes(x, w)
    if x.is_cuda:
        return _launch_fwd(x, w, conv3x3_patch, "patch")
    return conv3x3_patch_plain(x, w)


def _tout_yt(x, w):
    """The tout kernel's own output, yᵀ (F, N·H·W) in x's type, before the
    transpose back to NHWC (for timing the kernel alone); CUDA tensors only."""
    _check_shapes(x, w)
    return _launch_fwd(x, w, conv3x3_tout, "tout")


def _nhwc(yt, x):
    """yᵀ (F, N·H·W) turned back to (N, H, W, F): one copy, as the JAX
    package transposes outside its kernel; part of the mode's cost."""
    n, h, wd = x.shape[:3]
    return yt.view(-1, n, h, wd).permute(1, 2, 3, 0).contiguous()


def conv3x3_tout(x, w):
    """The tout mode's forward: x (N, H, W, C), w (3, 3, C, F) → (N, H, W,
    F) in x's type.  A CUDA tensor launches ``csrc/conv3x3_tout.cu`` (which
    writes yᵀ) and transposes its output back, or raises; a CPU tensor takes
    the plain version."""
    _check_shapes(x, w)
    if x.is_cuda:
        return _nhwc(_launch_fwd(x, w, conv3x3_tout, "tout"), x)
    return conv3x3_tout_plain(x, w)


def conv3x3_wgrad_tout(x, dy):
    """The tout mode's weight gradient: x (N, H, W, C), dy (N, H, W, F) in
    x's type → (3, 3, C, F) float32.  A CUDA tensor launches
    ``csrc/conv3x3_wgrad_tout.cu`` or raises; a CPU tensor takes the plain
    version."""
    _check_pair(x, dy)
    if x.is_cuda:
        return _launch_wgrad(x, dy, "tout")
    return conv3x3_wgrad_tout_plain(x, dy)


def conv3x3_fwd(x, w, mode="taps"):
    """The forward in one of the modes, without autograd: the counterpart of
    the JAX package's ``_conv_fwd(x, w, mode=)``.  ``taps`` is counted in
    ``conv3x3.launches`` (the model path's kernel), ``patch`` and ``tout`` in
    ``conv3x3_patch.launches`` and ``conv3x3_tout.launches``."""
    _check_mode("conv3x3_fwd", mode, FWD_MODES)
    if mode == "patch":
        return conv3x3_patch(x, w)
    if mode == "tout":
        return conv3x3_tout(x, w)
    _check_shapes(x, w)
    if x.is_cuda:
        return _launch_fwd(x, w, conv3x3)
    return conv3x3_plain(x, w)


def conv3x3_dgrad(g, w, mode="taps"):
    """Input gradient: g (N, H, W, F) with the forward's kernel w (3, 3, C,
    F) → (N, H, W, C) in g's type: the forward of ``mode`` on the rotated,
    transposed kernel.  A CUDA tensor launches that kernel (``taps`` counted
    in ``conv3x3_dgrad.launches``, the others in their forward's counter) or
    raises; a CPU tensor takes the plain version."""
    _check_mode("conv3x3_dgrad", mode, FWD_MODES)
    if mode != "taps":
        return conv3x3_fwd(g, _rotated(w), mode)
    _check_shapes(g, _rotated(w))
    if g.is_cuda:
        return _launch_fwd(g, _rotated(w), conv3x3_dgrad)
    return conv3x3_dgrad_plain(g, w)


def conv3x3_wgrad(x, dy, mode="taps"):
    """Weight gradient: x (N, H, W, C), dy (N, H, W, F) in x's type →
    (3, 3, C, F) float32, in ``mode`` (``taps`` or ``tout``; the counterpart
    of ``_conv_wgrad``).  A CUDA tensor launches the kernels or raises; a
    CPU tensor takes the plain version."""
    _check_mode("conv3x3_wgrad", mode, WGRAD_MODES)
    if mode == "tout":
        return conv3x3_wgrad_tout(x, dy)
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
    """3×3 stride-1 SAME NHWC convolution, differentiable, in the taps mode.

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
conv3x3_patch.launches = 0  # one per patch-kernel launch (forward or dgrad)
conv3x3_tout.launches = 0   # one per tout-kernel launch (forward or dgrad)
conv3x3_wgrad_tout.launches = 0   # one per tout weight-gradient launch
