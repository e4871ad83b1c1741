"""3-D CT encoder: MC3-18 video ResNet features.

Counterpart of the JAX package's ``models/ct_mc3.py``: a 1→3-channel
"downsampling" stem (kernel and stride keyed on the CT spacing) feeding
torchvision's ``mc3_18`` trunk, returning the **layer4 feature map** (no
pooling).  MC3 = 3-D convolutions in the stem and layer1, spatial-only
(1,3,3) convolutions in layers 2-4.

Layout.  Activations are **NDHWC, contiguous**, from the module's input
``(B, D, H, W, 1)`` to its output ``(B, D, H', W', 512)``, as in the JAX
package.  PyTorch's convolutions take NCDHW / NCHW, so each convolution
hands them a permuted *view* of the same memory (which is exactly the
``channels_last_3d`` / ``channels_last`` memory format, so cuDNN runs its
channels-last kernels and nothing is copied) and permutes the result back.
Folding depth into the batch, ``(B, D, H, W, C) → (B·D, H, W, C)``, is then
a reshape, and the folded tensor is what the hand-written ``conv3x3`` kernel
takes.  Weights are stored OIDHW under torchvision's ``mc3_18`` key names
(``stem.0/.1``, ``layer{i}.{b}.conv1.0/.1``, ``conv2.0/.1``,
``downsample.0/.1``) and the reference's ``downsampling.weight/.bias``.

Training as the JAX package trains it: BatchNorm normalises with the
batch's statistics and moves its running ones as flax does (biased variance,
momentum 0.9); ``remat`` (``Config.ct_remat``) recomputes the activations of
chosen stages in the backward with ``torch.utils.checkpoint``, one block at a
time, without moving the running statistics a second time; the
``fwd_lowering="conv3d"`` forward takes its gradients from the fold form, as
the JAX package's custom VJP does.  Depth sharding comes with the
``parallel`` slice; ``MedicalNetFeatures`` is not ported yet.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.kernels import conv3x3
from .layers import normal_

TEMPORAL_MODES = ("conv3d", "dfold", "dsum", "dshift")
CONV_BACKENDS = ("xla", "pallas")
FWD_LOWERINGS = ("fold", "conv3d")
REMAT_MODES = ("all", "early", "layer2", "none")


def conv2d_nhwc(x, k, stride, padding):
    """``F.conv2d`` of an NHWC tensor with an HWIO kernel, through views:
    x as NCHW in ``channels_last`` memory, k as OIHW likewise."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), None,
                 stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3d_ndhwc(x, weight, stride, padding):
    """``F.conv3d`` of an NDHWC tensor with an OIDHW weight, x viewed as
    NCDHW in ``channels_last_3d`` memory."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight, None, stride, padding)
    return y.permute(0, 2, 3, 4, 1).contiguous()


class _ConvParams(nn.Module):
    """A 5-D OIDHW ``weight`` (+ ``bias``) computing in ``dtype``; the cast
    (and, in subclasses, folded) weights are kept for inference, keyed by
    the parameter's storage and version so that a later ``load_state_dict``
    or ``.to(device)`` is seen."""

    def __init__(self, in_channels: int, features: int, kernel, stride,
                 padding, use_bias: bool, dtype: torch.dtype):
        super().__init__()
        self.kernel, self.stride, self.padding = \
            tuple(kernel), tuple(stride), tuple(padding)
        self.compute_dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(features, in_channels, *self.kernel))
        self.bias = nn.Parameter(torch.empty(features)) if use_bias else None
        self._cache = {}

    def init_weights(self, generator) -> None:
        """LeCun-normal weight, zero bias (flax ``nn.Conv``'s defaults)."""
        fan_in = self.weight.shape[1] * math.prod(self.kernel)
        normal_(self.weight, 1.0 / math.sqrt(fan_in), generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def _cached(self, name: str, make):
        w = self.weight
        if torch.is_grad_enabled() and w.requires_grad:
            return make(w)                      # autograd must see the cast
        key = (name, w.data_ptr(), w._version, w.device, self.compute_dtype)
        if key not in self._cache:
            self._cache.clear()                 # the weights changed
            with torch.no_grad():
                self._cache[key] = make(w)
        return self._cache[key]

    def _add_bias(self, out):
        if self.bias is None:
            return out
        return out + self.bias.to(out.dtype)


class Conv3d(_ConvParams):
    """A (kD,kH,kW) convolution of an NDHWC tensor.  A depth-independent
    (1,kH,kW) one folds D into the batch and runs as a 2-D convolution;
    anything else is ``F.conv3d``."""

    def forward(self, x):
        dt = self.compute_dtype
        w = self._cached("w", lambda p: p.to(dt))
        x = x.to(dt)
        if self.kernel[0] == 1 and self.stride[0] == 1 \
                and self.padding[0] == 0:
            b, d, h, wd, c = x.shape
            y = conv2d_nhwc(x.reshape(b * d, h, wd, c),
                            w[:, :, 0].permute(2, 3, 1, 0),
                            self.stride[1:], self.padding[1:])
            out = y.reshape(b, d, *y.shape[1:])
        else:
            out = conv3d_ndhwc(x, w, self.stride, self.padding)
        return self._add_bias(out)


class DepthFoldedConv(_ConvParams):
    """(kD,kH,kW) 3-D convolution computed by folding the depth taps into
    2-D convolutions; numerically a ``F.conv3d`` with the same 5-D weight.

    - ``dfold``: concatenate the kD depth-shifted views on channels
      (depth-tap-major), ONE 2-D convolution with kD·C input channels;
    - ``dsum``: kD separate 2-D convolutions, summed;
    - ``dshift``: ONE 2-D convolution over all padded slices with kD·F
      output channels (the per-tap kernels stacked on the output channels),
      then kD shifted slab adds.

    ``conv_backend="pallas"`` sends the 3×3, stride-1, pad-1 folded
    convolutions to the hand-written ``ops.kernels.conv3x3`` (MC3 layer1);
    ``"xla"`` leaves them to ``F.conv2d``.  ``fwd_lowering="conv3d"``
    (``dfold`` only, and only where the JAX package takes it) computes the
    forward as a plain ``F.conv3d``.
    """

    def __init__(self, in_channels: int, features: int, kernel, stride,
                 padding, mode: str = "dfold", use_bias: bool = False,
                 dtype: torch.dtype = torch.float32,
                 conv_backend: str = "xla", fwd_lowering: str = "fold"):
        super().__init__(in_channels, features, kernel, stride, padding,
                         use_bias, dtype)
        if mode not in TEMPORAL_MODES[1:]:
            raise ValueError(f"unknown DepthFoldedConv mode {mode!r}; "
                             f"expected one of {TEMPORAL_MODES[1:]}")
        self.mode = mode
        self.use_kernel = conv_backend == "pallas"
        self.fwd_lowering = fwd_lowering

    def _conv2d(self, x, k):
        """x: (N, H, W, C); k: HWIO in the compute type."""
        _, sh, sw = self.stride
        _, ph, pw = self.padding
        if self.use_kernel and tuple(k.shape[:2]) == (3, 3) \
                and (sh, sw) == (1, 1) and (ph, pw) == (1, 1):
            return conv3x3(x.contiguous(), k)
        return conv2d_nhwc(x, k, (sh, sw), (ph, pw))

    def _folded(self):
        """The 5-D weight as the mode's 2-D kernel(s), HWIO."""
        dt = self.compute_dtype
        f, cin, kd, kh, kw = self.weight.shape
        if self.mode == "dfold":        # input channel = depth tap · C + c
            return self._cached("dfold", lambda p: p.to(dt).permute(
                3, 4, 2, 1, 0).reshape(kh, kw, kd * cin, f).contiguous())
        if self.mode == "dshift":       # output channel = depth tap · F + f
            return self._cached("dshift", lambda p: p.to(dt).permute(
                3, 4, 1, 2, 0).reshape(kh, kw, cin, kd * f).contiguous())
        return self._cached("dsum", lambda p: p.to(dt).permute(
            2, 3, 4, 1, 0).contiguous())        # (kD, kH, kW, C, F)

    def _dfold(self, xp, k, dout):
        """The dfold form: the kD depth-shifted views of the padded input
        concatenated on channels, one 2-D convolution with the HWIO kernel
        k; (B·Dout, H', W', F)."""
        kd, sd = self.kernel[0], self.stride[0]
        b, _, h, w, cin = xp.shape
        span = sd * (dout - 1) + 1
        y = torch.cat([xp[:, i:i + span:sd] for i in range(kd)], dim=-1)
        return self._conv2d(y.reshape(b * dout, h, w, kd * cin), k)

    def forward(self, x):
        kd, kh, kw = self.kernel
        sd, sh, sw = self.stride
        pd, ph, pw = self.padding
        f = self.weight.shape[0]
        b, d, h, w, cin = x.shape
        x = x.to(self.compute_dtype)
        xp = F.pad(x, (0, 0, 0, 0, 0, 0, pd, pd)) if pd else x
        dout = (d + 2 * pd - kd) // sd + 1
        span = sd * (dout - 1) + 1

        if self.mode == "dfold":
            if self.fwd_lowering == "conv3d" and not self.use_kernel \
                    and cin >= 8 and (f < 128 or (kh == 1 and kw == 1)):
                out = _Conv3dFoldGrad.apply(
                    xp, self._cached("w", lambda p: p.to(x.dtype)), self)
                return self._add_bias(out)
            out = self._dfold(xp, self._folded(), dout)
        elif self.mode == "dshift":
            dp = xp.shape[1]
            y = self._conv2d(xp.reshape(b * dp, h, w, cin), self._folded())
            y = y.reshape(b, dp, *y.shape[1:])
            out = y[:, 0:span:sd, ..., 0:f]
            for i in range(1, kd):
                out = out + y[:, i:i + span:sd, ..., i * f:(i + 1) * f]
            out = out.reshape(b * dout, *out.shape[2:])
        else:                                          # dsum
            k = self._folded()
            out = None
            for i in range(kd):
                y = self._conv2d(
                    xp[:, i:i + span:sd].reshape(b * dout, h, w, cin), k[i])
                out = y if out is None else out + y
        out = self._add_bias(out)
        return out.reshape(b, dout, *out.shape[1:])


class _Conv3dFoldGrad(torch.autograd.Function):
    """``fwd_lowering="conv3d"``: the forward is one ``F.conv3d`` and the
    gradients are those of the dfold form, as the JAX package's custom VJP
    takes them (``jax.linear_transpose`` of the fold form).  PyTorch has no
    linear transpose, so the backward runs autograd over the fold form
    recomputed from the saved input: the same gradients, one more forward."""

    @staticmethod
    def forward(ctx, xp, w, conv):
        ctx.save_for_backward(xp, w)
        ctx.conv = conv
        _, ph, pw = conv.padding
        return conv3d_ndhwc(xp, w, conv.stride, (0, ph, pw))

    @staticmethod
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        conv = ctx.conv
        f, cin, kd, kh, kw = w.shape
        with torch.enable_grad():
            a = xp.detach().requires_grad_(ctx.needs_input_grad[0])
            k = w.detach().requires_grad_(ctx.needs_input_grad[1])
            k2 = k.permute(3, 4, 2, 1, 0).reshape(kh, kw, kd * cin, f)
            out = conv._dfold(a, k2, g.shape[1])
            wanted = [t for t in (a, k) if t.requires_grad]
            grads = iter(torch.autograd.grad(
                out, wanted, g.reshape(out.shape)))
        return (next(grads) if a.requires_grad else None,
                next(grads) if k.requires_grad else None, None)


class BatchNorm(nn.BatchNorm3d):
    """BatchNorm over the last (channel) axis of an NDHWC tensor, eps 1e-5,
    momentum 0.1 (flax's 0.9).  As flax's ``BatchNorm(dtype=bf16)`` it
    keeps fp32 statistics and parameters, computes in fp32 and returns the
    compute type.

    In training mode it normalises with the batch's mean and *biased*
    variance over (B, D, H, W) and moves the running statistics by those
    same values, as flax does (``nn.BatchNorm3d`` would store the unbiased
    variance): ``running = 0.9 · running + 0.1 · batch``.  The normalisation
    is ``F.batch_norm`` on a channels-last view (one statistics pass and one
    elementwise pass on the card, its own backward); the running update is
    written here.  ``update_stats = False`` leaves the running statistics
    alone: a rematerialised block's second forward sets it (flax's
    ``nn.remat`` moves them once)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.compute_dtype = dtype
        self.update_stats = True

    def forward(self, x):
        if not self.training:
            mul = torch.rsqrt(self.running_var + self.eps) * self.weight
            y = (x.float() - self.running_mean) * mul + self.bias
            return y.to(self.compute_dtype)
        c = x.shape[-1]
        view = x.to(self.compute_dtype).movedim(-1, 1)    # channels-last
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        # momentum 1 writes the batch's mean and unbiased variance into
        # the scratch buffers
        y = F.batch_norm(view, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        if self.update_stats:
            n = x.numel() // c
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean)
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * (var * ((n - 1) / n)))
                self.num_batches_tracked += 1
        return y.movedim(1, -1).contiguous()

    def init_weights(self, generator) -> None:
        self.reset_parameters()          # scale 1, bias 0, mean 0, var 1


class _ConvBN(nn.Sequential):
    """``0``: the convolution, ``1``: its BatchNorm (torchvision's
    numbering)."""

    def __init__(self, in_channels: int, features: int, kernel, stride,
                 padding, use_bias: bool = False,
                 dtype: torch.dtype = torch.float32,
                 temporal_mode: str = "conv3d", conv_backend: str = "xla",
                 fwd_lowering: str = "fold"):
        if kernel[0] > 1 and temporal_mode != "conv3d":
            conv = DepthFoldedConv(in_channels, features, kernel, stride,
                                   padding, mode=temporal_mode,
                                   use_bias=use_bias, dtype=dtype,
                                   conv_backend=conv_backend,
                                   fwd_lowering=fwd_lowering)
        else:
            conv = Conv3d(in_channels, features, kernel, stride, padding,
                          use_bias, dtype)
        super().__init__(conv, BatchNorm(features, dtype))


class BasicBlock3D(nn.Module):
    """Video-ResNet BasicBlock; ``temporal=True`` → (3,3,3) convolutions
    (Conv3DSimple), else (1,3,3) (Conv3DNoTemporal)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 temporal: bool = True, dtype: torch.dtype = torch.float32,
                 temporal_mode: str = "conv3d", conv_backend: str = "xla",
                 fwd_lowering: str = "fold"):
        super().__init__()
        if temporal:
            k, s, p = (3, 3, 3), (stride,) * 3, (1, 1, 1)
        else:
            k, s, p = (1, 3, 3), (1, stride, stride), (0, 1, 1)
        kw = dict(dtype=dtype, temporal_mode=temporal_mode,
                  conv_backend=conv_backend, fwd_lowering=fwd_lowering)
        self.conv1 = _ConvBN(in_channels, features, k, s, p, **kw)
        self.conv2 = _ConvBN(features, features, k, (1, 1, 1), p, **kw)
        self.downsample = None
        if in_channels != features or stride != 1:
            self.downsample = _ConvBN(in_channels, features, (1, 1, 1), s,
                                      (0, 0, 0), dtype=dtype)

    def forward(self, x):
        y = self.conv2(torch.relu(self.conv1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return torch.relu(x + y)


def _remat_mode(remat) -> str:
    """``Config.ct_remat`` after ``resolve_memory_config``, or the JAX
    module's booleans: True → 'all', False / None → 'none'."""
    if remat is True:
        return "all"
    if remat is False or remat is None:
        return "none"
    if remat not in REMAT_MODES:
        raise ValueError(f"unknown ct_remat {remat!r}; expected one of "
                         f"{REMAT_MODES} (or 'auto' before "
                         f"resolve_memory_config)")
    return remat


def _rematerialised(block: nn.Module, x):
    """``block(x)`` whose activations are recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant).  The recomputation runs
    with the block's BatchNorms' ``update_stats`` off, so that the running
    statistics move once a step, as under flax's ``nn.remat``; it normalises
    with the same batch statistics, so it gives the same activations.  The
    trunk draws no random numbers, so no RNG state is kept."""
    first = [True]

    def run(inp):
        if first[0]:
            first[0] = False
            return block(inp)
        norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
        for m in norms:
            m.update_stats = False
        try:
            return block(inp)
        finally:
            for m in norms:
                m.update_stats = True

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class VideoResNetFeatures(nn.Module):
    """MC3-18 trunk (stem + layers 1-4), returning the layer4 NDHWC map.

    ``temporal_layers`` selects which stages use full 3-D convolutions: MC3
    is (True, False, False, False); an all-True tuple gives R3D-18.  As in
    the JAX package the stem gets no ``conv_backend``: only layer1's
    (3,3,3) convolutions can reach the ``conv3x3`` kernel.  ``remat``
    ('all' | 'early' = stages 1-2 | 'layer2' | 'none') names the stages whose
    blocks are rematerialised when the module trains with autograd on.
    """

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 channels: Sequence[int] = (64, 128, 256, 512),
                 temporal_layers: Sequence[bool] = (True, False, False,
                                                    False),
                 dtype: torch.dtype = torch.float32,
                 temporal_mode: str = "conv3d", conv_backend: str = "xla",
                 fwd_lowering: str = "fold", remat="all"):
        super().__init__()
        self.remat = _remat_mode(remat)
        # BasicStem: Conv(3→64, (3,7,7), s(1,2,2), p(1,3,3)) + BN + ReLU
        self.stem = _ConvBN(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                            dtype=dtype, temporal_mode=temporal_mode,
                            fwd_lowering=fwd_lowering)
        width = 64
        self.n_stages = len(layers)
        for i, (n_blocks, feats, temporal) in enumerate(
                zip(layers, channels, temporal_layers)):
            blocks = []
            for b in range(n_blocks):
                blocks.append(BasicBlock3D(
                    width, feats, 2 if (i > 0 and b == 0) else 1, temporal,
                    dtype, temporal_mode=temporal_mode,
                    conv_backend=conv_backend, fwd_lowering=fwd_lowering))
                width = feats
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def _remat_stage(self, i: int) -> bool:
        return (self.remat == "all" or (self.remat == "early" and i < 2)
                or (self.remat == "layer2" and i == 1))

    def forward(self, x):
        x = torch.relu(self.stem(x))
        remat = self.training and torch.is_grad_enabled()
        for i in range(self.n_stages):
            stage = getattr(self, f"layer{i + 1}")
            if remat and self._remat_stage(i):
                for block in stage:
                    x = _rematerialised(block, x)
            else:
                x = stage(x)
        return x


class ResnetMC3_18(nn.Module):
    """Reference ``ResnetMC3_18``: spacing-keyed 1→3-channel Conv3d stem
    (``downsampling``) + MC3-18 trunk (``model``), returning the layer4 map.

    Input: (B, D, H, W, in_channels) NDHWC CT volume in [0, 1) (a second
    channel carries the tumour mask of the ``_wMask`` variant).
    Output: (B, D, H', W', 512) NDHWC feature map.
    """

    def __init__(self, in_channels: int = 1, spacing_xy: float = 0.6869,
                 dtype: torch.dtype = torch.float32,
                 layers: Sequence[int] = (2, 2, 2, 2),
                 temporal_mode: str = "conv3d", conv_backend: str = "xla",
                 fwd_lowering: str = "fold", remat="all"):
        super().__init__()
        for name, val, known in (
                ("ct_temporal_mode", temporal_mode, TEMPORAL_MODES),
                ("ct_conv_backend", conv_backend, CONV_BACKENDS),
                ("ct_fwd_lowering", fwd_lowering, FWD_LOWERINGS)):
            if val not in known:
                hint = (" (the port has no interpreter: on the CPU 'pallas' "
                        "already takes the kernel's plain version)"
                        if val == "pallas_interpret" else "")
                raise ValueError(f"unknown {name} {val!r}; expected one of "
                                 f"{known}{hint}")
        if spacing_xy == 2.0:
            k, s = (3, 3, 3), (1, 1, 1)
        else:
            # kernel (3,4,4), stride (1,2,2), padding 1 → floor((H-2)/2)+1
            k, s = (3, 4, 4), (1, 2, 2)
        if temporal_mode != "conv3d":
            self.downsampling = DepthFoldedConv(
                in_channels, 3, k, s, (1, 1, 1), mode=temporal_mode,
                use_bias=True, dtype=dtype)
        else:
            self.downsampling = Conv3d(in_channels, 3, k, s, (1, 1, 1),
                                       True, dtype)
        self.model = VideoResNetFeatures(
            layers=layers, dtype=dtype, temporal_mode=temporal_mode,
            conv_backend=conv_backend, fwd_lowering=fwd_lowering,
            remat=remat)

    def forward(self, x):
        return self.model(self.downsampling(x))
