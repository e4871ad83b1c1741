#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llmmil_tpu_torch``) on one NVIDIA
Hopper card: ``python3 chip_smoke.py``.

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card, drives the port's
main paths — the pathology + clinical-information flagship and the tri-modal
flagship with its CT trunk under ABMIL and under TransMIL (the paper's
default), each at full width, built, called and served over HTTP; training
the tri-modal flagship; the conv3x3 bench entry point in every mode — and
checks that the paths went through the kernels.  Any failed phase
ends the run with a non-zero exit; without a CUDA card it exits non-zero at
once.  The weights are random, made from a seed.  Phases:

  device    card name and power limit (nvidia-smi), torch and CUDA versions
  build     nvcc over llmmil_tpu_torch/csrc (all sources at once, -Xptxas
            -v: registers and spills), seconds; HGMMA and no HMMA in the
            SASS of mil_pool, conv3x3, conv3x3_tout, conv3x3_patch,
            conv3x3_wgrad and conv3x3_wgrad_tout (their bf16 kernels on
            wgmma)
  kernels   every kernel against its plain version at every shape, with
            times (mil_pool also on masks with holes and at N = 1, 63, 65,
            129); bf16 mil_pool and conv3x3 the same bits twice
  model     build_model → forward, bf16 kernel path against fp32 plain path
  serve     export_model → ServingModel → InferenceServer, HTTP requests
  model-ct  the tri-modal and the CT-only flagship on one 160 x 512 x 512
            volume: conv3x3 kernel route against the stock route, same type
  serve-ct  the tri-modal flagship exported and served over HTTP
  kernels-bwd  conv3x3's input and weight gradients (taps, and tout
            beside it) against their plain versions (the weight gradients
            against an fp64 sum), run to run bits of each, and cuDNN's
            backward for scale, at 160 and 320 slices and ragged shapes
  kernels-modes  conv3x3's patch and tout kernels (forward and input
            gradient) and the tout weight gradient against their plain
            versions at the path's shape and nine ragged ones;
            run to run bits of each; the tout kernel alone (its yT, before
            the wrapper's transpose back to NHWC) and that transpose alone
            beside its time through the wrapper; taps kernels and cuDNN for
            scale
  train     fit() on the synthetic full-width cohort (one 160 x 512 x 512
            volume and one 8192-bucket bag a patient, batch 2), one epoch
            and its validation; launches a step; a mid-epoch checkpoint
            resumed gives the same next step bit for bit; one step at batch
            1 on the conv3x3 route against the stock route, fp32 and bf16,
            and one layer1 convolution of a step on each route held against
            the plain versions on its own operands (dk against an fp64 sum)
  model-transmil  the tri-modal flagship with aggregator TransMIL on one
            160 x 512 x 512 volume: conv3x3 kernel route against the stock
            route, same type; mask-leak probe; res_conv's weight gradient
            (fp32, 8448 tokens) against an fp64 sum
  serve-transmil  that flagship exported and served over HTTP; pathology-
            only TransMIL at 1 x 16384 rows served, fp32 on the card held
            against the CPU
  bench-conv3x3  python -m llmmil_tpu_torch.eval.bench_conv3x3 in a
            subprocess at the path's shape: exit code, every mode's parity
            line and time row, the launch counts of the patch and tout kernels
  last      one JSON line for the kernels, the card, {"ok": true, ...}
"""

import concurrent.futures
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

from llmmil_tpu_torch import Config
from llmmil_tpu_torch.data.bags import bucket_for, pad_bag
from llmmil_tpu_torch.eval.export import (ServingModel, export_model,
                                          make_example_batch)
from llmmil_tpu_torch.eval.serve import InferenceServer
from llmmil_tpu_torch.data import BatchLoader, SyntheticCohort
from llmmil_tpu_torch.models import build_model
from llmmil_tpu_torch.models.abmil import ABMIL
from llmmil_tpu_torch.ops.kernels import (build, conv3x3, conv3x3_dgrad,
                                          conv3x3_dgrad_plain, conv3x3_fwd,
                                          conv3x3_patch, conv3x3_patch_plain,
                                          conv3x3_plain, conv3x3_tout,
                                          conv3x3_tout_plain, conv3x3_wgrad,
                                          conv3x3_wgrad_plain,
                                          conv3x3_wgrad_tout,
                                          conv3x3_wgrad_tout_plain, mil_pool,
                                          mil_pool_plain)
from llmmil_tpu_torch.ops.kernels.conv3x3 import _nhwc, _tout_yt
from llmmil_tpu_torch.parallel import ShardedEpochSampler, place_batch
from llmmil_tpu_torch.train import checkpoint as ckpt
from llmmil_tpu_torch.train import create_train_state, make_train_step
from llmmil_tpu_torch.train.loop import fit

SEED = 0
GATE_D = 192
# published dense peaks of one H100 SXM at its full 700 W power limit
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# Tolerances of kernel against plain version, scaled to the output: pooled
# values of an 8k-row softmax average are ~1e-2, so an absolute tolerance of
# that size would check nothing.
#  fp32 (TF32 off on both sides): only the order of the sums over N and L
#    differs -> pooled <= 1e-4 * max|plain|, attention <= 1e-6 absolute.
#  bf16: the plain version gets the same bf16-rounded bag but keeps V and U
#    in fp32, the kernel rounds them to bf16 (2^-9 relative each), which
#    moves a logit by ~1e-3 -> <= 2e-2 * max|plain| for both outputs.
TOL = {torch.float32: {"pooled_rel": 1e-4, "attn_abs": 1e-6},
       torch.bfloat16: {"pooled_rel": 2e-2, "attn_rel": 2e-2}}
# bf16 model against the same weights in fp32 through the plain pooling:
# bf16 keeps 8 bits, a probability near 0.5 moves in steps of 2^-9, and the
# error grows through two transformer blocks -> 3e-2 absolute on probs.
MODEL_ATOL = 3e-2

# conv3x3 kernel against its plain version, scaled to the largest output:
#  fp32: both make the same fp32 products; only the order of the 9·C sums
#    differs -> <= 1e-5 * max|plain|.
#  bf16: both round the same inputs to bf16, the products are exact in fp32,
#    both sum in fp32 and round once at the end, so only the order of the
#    sums differs; it can move a value across a rounding boundary, which is
#    one bf16 step, 2^-7 of the largest value at most -> <= 2^-7 * max|plain|.
CONV_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# CT models, conv3x3 kernel route against the stock route (F.conv2d, cuDNN)
# on the same weights and the same compute type, on the layer4 map relative
# to its largest value and on the probabilities.  bf16 against fp32 is no
# yardstick here: the untrained tri-modal model amplifies bf16 rounding.
#  fp32 (TF32 off): the two routes differ in the order of layer1's sums
#    (~1e-6 relative), carried through 12 more convolutions and the fusion
#    -> map <= 1e-4 * max, probabilities <= 1e-4.
#  bf16: layer1's outputs differ by one bf16 step (2^-8 relative) in a
#    fraction of their values; every later layer rounds to bf16 again and
#    the differences add up like a random walk over 16 roundings -> map
#    <= 4 * 2^-8 * sqrt(16) ~ 6e-2 * max; the heads pool 160 such tokens,
#    which averages the differences down -> probabilities <= 3e-2, the
#    tolerance of the pathology model's bf16 comparison.
CT_TOL = {"float32": {"map_rel": 1e-4, "probs_abs": 1e-4},
          "bfloat16": {"map_rel": 6e-2, "probs_abs": 3e-2}}

KERNEL_SHAPES = [            # (B, N, L, dtype); N+1 / N+10: the flagship
    (8, 8192, 768, torch.bfloat16),     # joins the CI tokens to the bag
    (8, 16384, 768, torch.bfloat16),
    (1, 8193, 512, torch.bfloat16),
    (8, 8193, 512, torch.bfloat16),
    (8, 8202, 512, torch.bfloat16),
    (1, 16385, 512, torch.bfloat16),
    (1, 16394, 512, torch.bfloat16),
    (1, 8372, 512, torch.bfloat16),     # tri-modal: bag + 160 slices + 2x10
    (1, 8202, 512, torch.bfloat16),     # its pathology head
    (1, 170, 512, torch.bfloat16),      # its CT head: 160 slices + 10 CI
    (8, 8192, 512, torch.float32),      # the fp32 path at a large shape
    (2, 700, 256, torch.float32),
    (2, 130, 256, torch.float32),
]
HEADLINE_SHAPE = KERNEL_SHAPES[0]
# bags whose mask has holes (whole masked tiles between valid rows) and
# ragged lengths around one 64-row tile: (B, N, L, dtype, holes)
RAGGED_SHAPES = [
    (8, 8192, 768, torch.bfloat16, True),
    (1, 8202, 512, torch.bfloat16, True),
    (3, 1, 512, torch.bfloat16, False),
    (3, 63, 512, torch.bfloat16, False),
    (3, 65, 512, torch.bfloat16, False),
    (3, 129, 512, torch.bfloat16, False),
    (2, 700, 256, torch.float32, True),
]
CONV_SHAPES = [              # (N, H, W, C, F, dtype)
    (160, 128, 128, 192, 64, torch.bfloat16),   # MC3 layer1, dfold: the path
    (320, 128, 128, 192, 64, torch.bfloat16),   # the same at fit()'s batch 2
    (16, 128, 128, 192, 64, torch.float32),     # the same in fp32, 16 slices
    (16, 128, 128, 64, 192, torch.bfloat16),    # dshift
    (16, 128, 128, 64, 64, torch.bfloat16),     # dsum
    (2, 33, 31, 20, 70, torch.bfloat16),        # ragged everywhere: the
    #                                             bf16 kernel's cp.async loader
    (3, 17, 13, 24, 40, torch.bfloat16),        # ragged, C and F multiples of
    #                                             8: its TMA loader
    (2, 10, 16, 8, 4, torch.float32),
    (3, 17, 13, 24, 40, torch.float32),
]
CONV_HEADLINE = CONV_SHAPES[0]
# conv3x3's backward: x (N, H, W, C) and g (N, H, W, F).  The input gradient
# is the forward kernel on g with the rotated kernel (F -> C), held to
# CONV_TOL.  The weight gradients (taps, and tout, the same function in the
# other orientation) sum N·H·W products per value (2.6M at the path) in
# fp32, in another order than any reference; each is held against an fp64
# sum of the same (type-rounded) operands.  Each block sums up to ~33k
# exact products sequentially and the partials are added in a fixed order,
# so the fp32 error stays near 2^-24 · sqrt(terms) of the magnitudes summed:
# <= 1e-4 * max|dw| for both types.  (bf16's wgmma accumulation errs more,
# linearly in a range's length; the kernel keeps its ranges short enough to
# stay well inside this: eval/probe_wgrad_ranges.py.)
BWD_SHAPES = [              # (N, H, W, C, F, dtype)
    (160, 128, 128, 192, 64, torch.bfloat16),   # MC3 layer1, dfold: the path
    (320, 128, 128, 192, 64, torch.bfloat16),   # at fit()'s batch 2: another
    #                                             plan of pixel ranges
    (16, 128, 128, 192, 64, torch.float32),     # the same in fp32, 16 slices
    (2, 33, 31, 20, 70, torch.bfloat16),        # ragged everywhere
    (3, 17, 13, 24, 40, torch.bfloat16),        # ragged; dx by TMA
    (2, 10, 16, 8, 4, torch.float32),
    (3, 17, 13, 24, 40, torch.float32),
]
WGRAD_TOL = 1e-4
# One train step at batch 1, conv3x3 route against the stock route (cuDNN
# forward and backward), same weights, same batch, dropout off, relative to
# the largest |value| of each compared tensor:
#  fp32 (TF32 off): the routes differ in the order of layer1's sums (~1e-6
#    relative), which the backward carries through 13 convolutions and the
#    batch statistics of every BatchNorm -> loss <= 1e-5, the heads'
#    gradients <= 1e-3.
#  bf16: layer1's outputs and input gradients differ by one bf16 step in a
#    fraction of their values; the forward rounds 16 more times and the
#    backward as often -> loss <= 3e-2 absolute (CT_TOL's heads); the heads'
#    gradients pool those differences -> <= 6e-2 (CT_TOL's map).
# Layer1's weight gradients are read, not held, across the routes: they are
# sums of 2.6M products x·dy that cancel (x leaves a ReLU, dy leaves
# BatchNorm's backward with zero mean a channel; Σ|x·dy| is ~165 times the
# largest |dk| at this batch), so the small differences between the two
# routes' x and dy come out amplified (~6e-3 of the max in fp32, ~27 % in
# bf16).  Instead, in a further step on each route, one layer1
# convolution keeps its operands x, k and dy and its results y, dx and dk,
# and each is held against the plain version on those same tensors: y and
# dx (conv3x3 route) to CONV_TOL, and dk (both routes) element by element to
# a sum in fp64:
#   |dk - dk64| <= r·|dk64| + STEP_WGRAD_TOL·S,   S = Σ|x|·|dy| (fp64)
# r is the rounding of dk to the kernel's type (0 in fp32; 2^-7, twice
# bf16's 2^-8, in bf16).  The kernel's fp32 sums are chains of additions:
# a block's pixel range (<= 16384 pixels, one FMA a pixel, in fp32; <= 32768
# pixels, one wgmma k16 step per 16 pixels, in bf16), then the <= ~350
# partials.  Their
# rounding grows like 2^-24·sqrt(additions) times the magnitudes summed, at
# most 2^-24·sqrt(16.7k)·S ~ 7.7e-6·S: 2e-5·S leaves a factor 2.6.  cuDNN's
# order is its own; the same bound is asked of it.
STEP_TOL = {"float32": {"loss": 1e-5, "head_rel": 1e-3},
            "bfloat16": {"loss": 3e-2, "head_rel": 6e-2}}
STEP_WGRAD_TOL = 2e-5
STEP_WGRAD_ROUND = {"float32": 0.0, "bfloat16": 2.0 ** -7}
WATCHED_CONV = "extractor_CT.model.layer1.0.conv1.0"    # a DepthFoldedConv
TRAIN_BATCH = 2             # ct_remat auto -> 'early' (stages 1 and 2)
TRAIN_PATIENTS = 3          # a hospital: 9 train-hospital patients, 6 train
BAG_RANGE = (5200, 8193)    # rows before instance dropout; 8192 bucket
LAYER1_GRADS = tuple(f"extractor_CT.model.layer1.{b}.conv{c}.0.weight"
                     for b in (0, 1) for c in (1, 2))
HEAD_GRADS = ("fc.1.weight", "fc_CT.1.weight", "fc_Pth.1.weight")
MODEL_BATCHES = ((8, 8192), (1, 16384))           # (batch, bag bucket)
SERVE_SIGNATURES = ((1, 8192), (1, 16384), (8, 8192))
CT_DEPTH, CT_BAG = 160, 8192        # one volume of 160 x 512 x 512, one bag
DEV = "cuda"


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, iters, warmup=2):
    """Mean milliseconds of ``fn()`` by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- kernels --

def kernel_inputs(b, n, l, dtype, gen, holes=False):
    """A bag, its mask (a prefix of N/2 to N valid rows; with ``holes``,
    rows 512 k + 128 .. 512 k + 447 masked too, two whole 128-row tiles and
    more) and the gate parameters."""
    dev = DEV
    x = torch.randn(b, n, l, generator=gen, device=dev).to(dtype)
    n_valid = torch.randint(n // 2, n + 1, (b, 1), generator=gen, device=dev)
    rows = torch.arange(n, device=dev)[None]
    mask = rows < n_valid
    if holes:
        mask &= ~((rows % 512 >= 128) & (rows % 512 < 448))
    scale = 0.05
    params = [torch.randn(l, GATE_D, generator=gen, device=dev) * scale,
              torch.randn(GATE_D, generator=gen, device=dev) * scale,
              torch.randn(l, GATE_D, generator=gen, device=dev) * scale,
              torch.randn(GATE_D, generator=gen, device=dev) * scale,
              torch.randn(GATE_D, 1, generator=gen, device=dev) * scale,
              torch.randn(1, generator=gen, device=dev) * scale]
    return x, mask, params


def mil_pool_bound_ms(mask, l, dtype):
    """Least time the card could take for this call: the valid rows read
    once and the outputs written once over the memory rate, against the
    operations on the valid rows over the peak rate of the bag's type."""
    b, n = mask.shape
    rows = int(mask.sum())
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (rows * l * item + b * n            # bag rows, mask
              + 2 * l * GATE_D * item + (3 * GATE_D + 1) * 4   # weights
              + (b * l + b * n) * 4)             # pooled, attention
    flops = 2 * rows * l * (2 * GATE_D + 1) + 2 * rows * l
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def compare_mil_pool(x, mask, params):
    """Kernel and plain version on the same inputs; returns the errors and
    the tolerances they were held to."""
    pooled, attn = mil_pool(x, mask, *params)
    torch.cuda.synchronize()
    ref_pooled, ref_attn = mil_pool_plain(x, mask, *params)
    check(pooled.shape == ref_pooled.shape and attn.shape == ref_attn.shape
          and pooled.dtype == torch.float32 and attn.dtype == torch.float32,
          "mil_pool: wrong output shape or type")
    check(bool(torch.isfinite(pooled).all() and torch.isfinite(attn).all()),
          "mil_pool: non-finite output")
    tol = TOL[x.dtype]
    pooled_err = float((pooled - ref_pooled).abs().max())
    attn_err = float((attn - ref_attn).abs().max())
    pooled_tol = tol["pooled_rel"] * float(ref_pooled.abs().max())
    attn_tol = tol.get("attn_abs") or \
        tol["attn_rel"] * float(ref_attn.abs().max())
    check(bool((attn[~mask] == 0).all()),
          "mil_pool: non-zero attention on a masked row")
    return pooled, attn, {"pooled_err": pooled_err, "pooled_tol": pooled_tol,
                          "attn_err": attn_err, "attn_tol": attn_tol}


def kernels_phase():
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    shapes = []
    for b, n, l, dtype, holes in [(*s, False) for s in KERNEL_SHAPES] + \
            RAGGED_SHAPES:
        x, mask, params = kernel_inputs(b, n, l, dtype, gen, holes)
        pooled, attn, rec = compare_mil_pool(x, mask, params)
        name = f"{b}x{n}x{l} {str(dtype).split('.')[-1]}" + \
            (" holes" if holes else "")
        check(rec["pooled_err"] <= rec["pooled_tol"]
              and rec["attn_err"] <= rec["attn_tol"],
              f"mil_pool disagrees with its plain version at {name}: {rec}")
        if dtype == torch.bfloat16:
            # one launch, persistent blocks, joins in a fixed order: the
            # same inputs give the same bits
            again = mil_pool(x, mask, *params)
            check(torch.equal(again[0], pooled) and torch.equal(again[1], attn),
                  f"mil_pool: two calls gave different bits at {name}")
            rec["same_bits"] = True
            rows, blocks = mil_pool.launcher.plan(b, n)
            rec["plan"] = f"{rows}-row tiles, {blocks} blocks"

        # NaN in masked rows must change nothing, bit for bit
        dirty = x.clone()
        dirty[~mask] = float("nan")
        d_pooled, d_attn = mil_pool(dirty, mask, *params)
        check(torch.equal(d_pooled, pooled) and torch.equal(d_attn, attn),
              f"mil_pool: NaN in masked rows leaked at {name}")
        # an all-masked bag gives zeros
        none = mask.clone()
        none[0] = False
        z_pooled, z_attn = mil_pool(x, none, *params)
        check(bool((z_pooled[0] == 0).all() and (z_attn[0] == 0).all()
                   and torch.isfinite(z_pooled).all()),
              f"mil_pool: all-masked bag is not zeros at {name}")
        if b > 1:
            check(torch.equal(z_pooled[1:], pooled[1:]),
                  f"mil_pool: bags are not independent at {name}")

        big = b * n * l >= 1 << 22
        ms = time_ms(lambda: mil_pool(x, mask, *params), 20 if big else 50)
        plain_ms = time_ms(lambda: mil_pool_plain(x, mask, *params),
                           5 if big else 20)
        bound_ms, bound_by = mil_pool_bound_ms(mask, l, dtype)
        shapes.append({"shape": name, "valid_rows": int(mask.sum()), **rec,
                       "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by})
        del x, dirty
    return shapes


def conv3x3_bound_ms(shape):
    """Least time the card could take: x, k read once and y written once
    over the memory rate, against 2·N·H·W·9·C·F operations over the peak
    rate of the tensor's type."""
    n, h, w, c, f, dtype = shape
    item = torch.empty((), dtype=dtype).element_size()
    nbytes = (n * h * w * (c + f) + 9 * c * f) * item
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_flops = 2 * n * h * w * 9 * c * f / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def conv2d_library(x, k):
    """The one PyTorch call that computes the same function: F.conv2d on a
    channels_last view (cuDNN).  Timed here, used nowhere in the kernel."""
    return F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)


def conv_kernels_phase():
    gen = torch.Generator(device=DEV).manual_seed(SEED + 2)
    shapes = []
    for shape in CONV_SHAPES:
        n, h, w, c, f, dtype = shape
        name = f"{n}x{h}x{w}x{c}->{f} {str(dtype).split('.')[-1]}"
        x = torch.randn(n, h, w, c, generator=gen, device=DEV).to(dtype)
        k = torch.randn(3, 3, c, f, generator=gen, device=DEV) \
            * (9 * c) ** -0.5                       # fp32, as the module's
        y = conv3x3(x, k)
        again = conv3x3(x, k)
        torch.cuda.synchronize()
        same_bits = torch.equal(y, again)
        check(same_bits, f"conv3x3: two runs differ at {name}")
        del again
        ref = conv3x3_plain(x, k)
        check(y.shape == ref.shape and y.dtype == dtype and y.is_contiguous(),
              f"conv3x3: wrong output shape or type at {name}")
        check(bool(torch.isfinite(y).all()), f"conv3x3: non-finite at {name}")
        top = float(ref.float().abs().max())
        err = float((y.float() - ref.float()).abs().max())
        tol = CONV_TOL[dtype] * top
        check(err <= tol, f"conv3x3 disagrees with its plain version at "
              f"{name}: {err} > {tol}")
        kt = k.to(dtype)
        lib = conv2d_library(x, kt).permute(0, 2, 3, 1)
        lib_err = float((lib.float() - ref.float()).abs().max())
        off_library = int((lib != y).sum())     # elements, bit for bit
        del lib
        big = n * h * w * c * f >= 1 << 28
        ms = time_ms(lambda: conv3x3(x, k), 10 if big else 50)
        library_ms = time_ms(lambda: conv2d_library(x, kt),
                             10 if big else 50)
        plain_ms = time_ms(lambda: conv3x3_plain(x, k), 2 if big else 10,
                           warmup=1)
        bound_ms, bound_by = conv3x3_bound_ms(shape)
        shapes.append({"shape": name, "err": err, "tol": tol,
                       "same_bits": same_bits, "library_err": lib_err,
                       "differs_from_library": off_library,
                       "differs_from_plain": int((ref != y).sum()),
                       "elements": y.numel(), "ms": ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by})
        del x, y, ref
        torch.cuda.empty_cache()
    return shapes


def conv_bwd_bound_ms(shape, which):
    """Least time for one gradient: its two inputs read once, its output
    written once, against the forward's 2·N·H·W·9·C·F operations."""
    n, h, w, c, f, dtype = shape
    item = torch.empty((), dtype=dtype).element_size()
    if which == "dgrad":        # g and k in, dx out, all in the type
        nbytes = (n * h * w * (c + f) + 9 * c * f) * item
    else:                       # x and g in, dw out in fp32
        nbytes = n * h * w * (c + f) * item + 9 * c * f * 4
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_flops = 2 * n * h * w * 9 * c * f / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def conv_bwd_library(x, g, kt, which):
    """The one PyTorch call per gradient (cuDNN backward-data and
    backward-filter on channels_last views).  Timed here, used nowhere in
    the port."""
    xc, gc = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    if which == "dgrad":
        return torch.nn.grad.conv2d_input(xc.shape, kt.permute(3, 2, 0, 1),
                                          gc, padding=1)
    return torch.nn.grad.conv2d_weight(xc, (kt.shape[3], kt.shape[2], 3, 3),
                                       gc, padding=1)


def conv_bwd_phase():
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    rows = []
    for shape in BWD_SHAPES:
        n, h, w, c, f, dtype = shape
        name = f"{n}x{h}x{w}x{c}->{f} {str(dtype).split('.')[-1]}"
        x = torch.randn(n, h, w, c, generator=gen, device=DEV).to(dtype)
        g = torch.randn(n, h, w, f, generator=gen, device=DEV).to(dtype)
        # the kernel the trunk hands in: cast to the compute type
        kt = (torch.randn(3, 3, c, f, generator=gen, device=DEV)
              * (9 * c) ** -0.5).to(dtype)

        dx = conv3x3_dgrad(g, kt)
        again = conv3x3_dgrad(g, kt)
        torch.cuda.synchronize()
        d_same_bits = torch.equal(dx, again)
        check(d_same_bits, f"conv3x3_dgrad: two runs differ at {name}")
        del again
        ref = conv3x3_dgrad_plain(g, kt)
        check(dx.shape == (n, h, w, c) and dx.dtype == dtype
              and bool(torch.isfinite(dx).all()),
              f"conv3x3_dgrad: wrong or non-finite output at {name}")
        top = float(ref.float().abs().max())
        d_err = float((dx.float() - ref.float()).abs().max())
        d_tol = CONV_TOL[dtype] * top
        check(d_err <= d_tol, f"conv3x3_dgrad disagrees with its plain "
              f"version at {name}: {d_err} > {d_tol}")
        lib = conv_bwd_library(x, g, kt, "dgrad").permute(0, 2, 3, 1)
        d_lib_err = float((lib.float() - ref.float()).abs().max())
        del lib, ref

        dw = conv3x3_wgrad(x, g)
        again = conv3x3_wgrad(x, g)
        torch.cuda.synchronize()
        same_bits = torch.equal(dw, again)
        check(same_bits, f"conv3x3_wgrad: two runs differ at {name}")
        ref64 = conv3x3_wgrad_plain(x, g, torch.float64)
        check(dw.shape == (3, 3, c, f) and dw.dtype == torch.float32
              and bool(torch.isfinite(dw).all()),
              f"conv3x3_wgrad: wrong or non-finite output at {name}")
        w_top = float(ref64.abs().max())
        w_err = float((dw.double() - ref64).abs().max())
        w_tol = WGRAD_TOL * w_top
        check(w_err <= w_tol, f"conv3x3_wgrad disagrees with the fp64 sum "
              f"at {name}: {w_err} > {w_tol}")
        lib = conv_bwd_library(x, g, kt, "wgrad").permute(2, 3, 1, 0)
        w_lib_err = float((lib.double() - ref64).abs().max())
        plain32 = conv3x3_wgrad_plain(x, g)
        w_plain_err = float((plain32.double() - ref64).abs().max())
        del lib, again, plain32
        # the tout weight gradient, the same function: the same reference
        dwt = conv3x3_wgrad(x, g, "tout")
        again = conv3x3_wgrad(x, g, "tout")
        torch.cuda.synchronize()
        t_same_bits = torch.equal(dwt, again)
        check(t_same_bits, f"conv3x3_wgrad_tout: two runs differ at {name}")
        check(dwt.shape == (3, 3, c, f) and dwt.dtype == torch.float32
              and bool(torch.isfinite(dwt).all()),
              f"conv3x3_wgrad_tout: wrong or non-finite output at {name}")
        t_err = float((dwt.double() - ref64).abs().max())
        check(t_err <= w_tol, f"conv3x3_wgrad_tout disagrees with the fp64 "
              f"sum at {name}: {t_err} > {w_tol}")
        del dwt, again, ref64

        big = n * h * w * c * f >= 1 << 28
        it, pit = (10, 2) if big else (50, 10)
        row = {"shape": name,
               "dgrad_err": d_err, "dgrad_tol": d_tol,
               "dgrad_same_bits": d_same_bits,
               "dgrad_library_err": d_lib_err,
               "wgrad_err": w_err, "wgrad_tol": w_tol,
               "wgrad_library_err": w_lib_err,
               "wgrad_plain_fp32_err": w_plain_err,
               "wgrad_same_bits": same_bits,
               "wgrad_tout_err": t_err, "wgrad_tout_same_bits": t_same_bits,
               "wgrad_tout_ms": time_ms(lambda: conv3x3_wgrad(x, g, "tout"),
                                        it)}
        for which, run, plain in (
                ("dgrad", lambda: conv3x3_dgrad(g, kt),
                 lambda: conv3x3_dgrad_plain(g, kt)),
                ("wgrad", lambda: conv3x3_wgrad(x, g),
                 lambda: conv3x3_wgrad_plain(x, g))):
            row[f"{which}_ms"] = time_ms(run, it)
            row[f"{which}_library_ms"] = time_ms(
                lambda: conv_bwd_library(x, g, kt, which), it)
            row[f"{which}_plain_ms"] = time_ms(plain, pit, warmup=1)
            bound, by = conv_bwd_bound_ms(shape, which)
            row[f"{which}_bound_ms"], row[f"{which}_bound_by"] = bound, by
        rows.append(row)
        del x, g, dx, dw
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------- kernels-modes --
# conv3x3's patch and tout kernels, forward and input gradient, and the tout
# weight gradient, against their plain versions: at MC3 layer1's shape (the
# forward at (160,128,128,192)->64, the input gradient at (160,128,128,64)
# ->192) and at ragged shapes, three in both types and three more in bf16
# whose strides TMA takes (ragged tiles and chunks, two 192-channel tiles of
# patch's input-gradient shape); the taps kernels and
# cuDNN beside them for scale.  Tolerances as for the taps kernels, for the
# same reasons: CONV_TOL for the forward and the input gradient (the same
# rounded inputs, exact products, fp32 sums in another order), WGRAD_TOL of
# an fp64 sum of the same operands for the weight gradient.
MODE_SHAPES = [             # (N, H, W, C, F, dtype)
    (160, 128, 128, 192, 64, torch.bfloat16),   # MC3 layer1, dfold: the path
    (2, 33, 31, 20, 70, torch.bfloat16),        # ragged everywhere
    (2, 33, 31, 20, 70, torch.float32),
    (3, 17, 13, 24, 40, torch.bfloat16),
    (3, 17, 13, 24, 40, torch.float32),
    (2, 10, 16, 8, 4, torch.bfloat16),
    (2, 10, 16, 8, 4, torch.float32),
    (2, 20, 72, 16, 24, torch.bfloat16),        # TMA, ragged tiles
    (1, 9, 200, 136, 72, torch.bfloat16),       # TMA, ragged chunks
    (1, 7, 9, 200, 260, torch.bfloat16),        # patch: two 192-ch tiles
]
MODE_PLAIN = {"patch": conv3x3_patch_plain, "tout": conv3x3_tout_plain}


def modes_phase():
    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    rows = []
    for shape in MODE_SHAPES:
        n, h, w, c, f, dtype = shape
        name = f"{n}x{h}x{w}x{c}->{f} {str(dtype).split('.')[-1]}"
        x = torch.randn(n, h, w, c, generator=gen, device=DEV).to(dtype)
        g = torch.randn(n, h, w, f, generator=gen, device=DEV).to(dtype)
        kt = (torch.randn(3, 3, c, f, generator=gen, device=DEV)
              * (9 * c) ** -0.5).to(dtype)
        k_rot = kt.flip((0, 1)).transpose(2, 3)      # the input gradient's
        big = n * h * w * c * f >= 1 << 28
        it, pit = (10, 2) if big else (50, 10)
        row = {"shape": name}
        for op, a, k in (("fwd", x, kt), ("dgrad", g, k_rot)):
            for mode, plain in MODE_PLAIN.items():
                y = conv3x3_fwd(a, k, mode)
                again = conv3x3_fwd(a, k, mode)
                torch.cuda.synchronize()
                same_bits = torch.equal(y, again)
                check(same_bits, f"conv3x3 {op} {mode}: two runs differ at "
                      f"{name}")
                del again
                ref = plain(a, k)
                check(y.shape == ref.shape and y.dtype == dtype
                      and y.is_contiguous() and bool(torch.isfinite(y).all()),
                      f"conv3x3 {op} {mode}: wrong or non-finite output at "
                      f"{name}")
                err = float((y.float() - ref.float()).abs().max())
                tol = CONV_TOL[dtype] * float(ref.float().abs().max())
                check(err <= tol, f"conv3x3 {op} {mode} disagrees with its "
                      f"plain version at {name}: {err} > {tol}")
                del y, ref
                row[f"{op}_{mode}"] = {
                    "err": err, "tol": tol, "same_bits": same_bits,
                    "ms": time_ms(lambda: conv3x3_fwd(a, k, mode), it),
                    "plain_ms": time_ms(lambda: plain(a, k), pit, warmup=1)}
                if mode == "tout":     # the kernel alone, and the transpose
                    yt = _tout_yt(a, k)
                    row[f"{op}_{mode}"]["kernel_ms"] = time_ms(
                        lambda: _tout_yt(a, k), it)
                    row[f"{op}_{mode}"]["transpose_ms"] = time_ms(
                        lambda: _nhwc(yt, a), it)
                    del yt
            row[f"{op}_taps_ms"] = time_ms(lambda: conv3x3_fwd(a, k), it)
            row[f"{op}_library_ms"] = time_ms(
                (lambda: conv2d_library(x, kt)) if op == "fwd" else
                (lambda: conv_bwd_library(x, g, kt, "dgrad")), it)
            bound, by = (conv3x3_bound_ms(shape) if op == "fwd"
                         else conv_bwd_bound_ms(shape, "dgrad"))
            row[f"{op}_bound_ms"], row[f"{op}_bound_by"] = bound, by
        dw = conv3x3_wgrad(x, g, "tout")
        again = conv3x3_wgrad(x, g, "tout")
        torch.cuda.synchronize()
        same_bits = torch.equal(dw, again)
        check(same_bits, f"conv3x3_wgrad_tout: two runs differ at {name}")
        ref64 = conv3x3_wgrad_tout_plain(x, g, torch.float64)
        check(dw.shape == (3, 3, c, f) and dw.dtype == torch.float32
              and bool(torch.isfinite(dw).all()),
              f"conv3x3_wgrad_tout: wrong or non-finite output at {name}")
        w_err = float((dw.double() - ref64).abs().max())
        w_tol = WGRAD_TOL * float(ref64.abs().max())
        check(w_err <= w_tol, f"conv3x3_wgrad_tout disagrees with the fp64 "
              f"sum at {name}: {w_err} > {w_tol}")
        del dw, again, ref64
        bound, by = conv_bwd_bound_ms(shape, "wgrad")
        row["wgrad_tout"] = {
            "err": w_err, "tol": w_tol, "same_bits": same_bits,
            "ms": time_ms(lambda: conv3x3_wgrad(x, g, "tout"), it),
            "plain_ms": time_ms(lambda: conv3x3_wgrad_tout_plain(x, g), pit,
                                warmup=1),
            "taps_ms": time_ms(lambda: conv3x3_wgrad(x, g), it),
            "library_ms": time_ms(
                lambda: conv_bwd_library(x, g, kt, "wgrad"), it),
            "bound_ms": bound, "bound_by": by}
        rows.append(row)
        del x, g
        torch.cuda.empty_cache()
    return rows


def print_modes(rows):
    for r in rows:
        parts = []
        for op in ("fwd", "dgrad"):
            parts.append(" ".join(
                f"{op} {m} err {r[f'{op}_{m}']['err']:.2e} (tol "
                f"{r[f'{op}_{m}']['tol']:.2e}; same bits twice "
                f"{r[f'{op}_{m}']['same_bits']}) ms {r[f'{op}_{m}']['ms']:.4f}"
                + (f" (kernel alone {r[f'{op}_{m}']['kernel_ms']:.4f}, "
                   f"transpose alone {r[f'{op}_{m}']['transpose_ms']:.4f})"
                   if m == "tout" else "") +
                f" plain_ms {r[f'{op}_{m}']['plain_ms']:.4f}"
                for m in MODE_PLAIN) + f" taps_ms {r[f'{op}_taps_ms']:.4f} "
                f"cuDNN_ms {r[f'{op}_library_ms']:.4f} bound_ms "
                f"{r[f'{op}_bound_ms']:.4f} ({r[f'{op}_bound_by']})")
        wt = r["wgrad_tout"]
        parts.append(f"wgrad tout err vs fp64 {wt['err']:.2e} (tol "
                     f"{wt['tol']:.2e}) same bits twice {wt['same_bits']} ms "
                     f"{wt['ms']:.4f} plain_ms {wt['plain_ms']:.4f} taps_ms "
                     f"{wt['taps_ms']:.4f} cuDNN_ms {wt['library_ms']:.4f} "
                     f"bound_ms {wt['bound_ms']:.4f} ({wt['bound_by']})")
        print(f"[kernels-modes] {r['shape']}: " + " | ".join(parts),
              flush=True)


# ------------------------------------------------------------------ model --

def flagship_cfg(model_ci):
    kw = dict(modality=["pathology"], model_pathology="ABMIL",
              aggregator="ABMIL", loss_point="Last",
              compute_dtype="bfloat16", use_pallas=True, seed=SEED)
    if model_ci == "CLIP":
        kw.update(model_CI="CLIP", CI_input_version="text",
                  CI_prompt_version="devided", learnablePrompt=1, n_ctx=8)
    else:
        kw.update(model_CI="simpleFCs_v1", CI_input_version="v1",
                  learnablePrompt=0)
    return Config(**kw)


def ragged_batch(cfg, batch, bucket, rs):
    """A batch as the data layer makes it: bags of ragged length, each
    padded to its bucket with its validity mask."""
    bags, masks = [], []
    for _ in range(batch):
        n = int(rs.randint(bucket // 2 + 1, bucket + 1))
        check(bucket_for(n, cfg.bag_buckets) == bucket, "bucket_for")
        bag, mask = pad_bag(rs.randn(n, 768).astype(np.float32), bucket)
        bags.append(bag)
        masks.append(mask)
    out = {"input_pathology": np.stack(bags), "mask_pathology": np.stack(masks)}
    if cfg.model_CI == "CLIP":
        n_p, t = cfg.n_clinical + 1, cfg.clip_context
        toks = np.zeros((batch, n_p, t), np.int32)
        length = rs.randint(cfg.n_ctx + 4, t, (batch, n_p))
        body = rs.randint(1, cfg.clip_vocab - 2, (batch, n_p, t))
        inside = np.arange(t)[None, None] < length[..., None]
        toks[inside] = body[inside]
        toks[..., 0] = cfg.clip_vocab - 2                    # SOT
        np.put_along_axis(toks, length[..., None], cfg.clip_vocab - 1, -1)
        out["input_CI"] = toks                               # EOT = argmax
    else:
        out["input_CI"] = rs.rand(batch, cfg.ci_input_dim).astype(np.float32)
    return out


def to_device(batch):
    return {k: torch.from_numpy(v).to(DEV) for k, v in batch.items()}


def forward_checked(model, tensors, what):
    """One forward; the launch counter must rise by exactly one."""
    before = mil_pool.launches
    with torch.inference_mode():
        probs = model(tensors)["probs"]
    torch.cuda.synchronize()
    check(mil_pool.launches == before + 1,
          f"{what}: {mil_pool.launches - before} kernel launches in one "
          "forward, expected 1")
    return probs


def model_phase():
    rs = np.random.RandomState(SEED)
    lines = []
    to_serve = None          # the first flagship goes on to the serve phase
    for model_ci in ("simpleFCs_v1", "CLIP"):
        cfg = flagship_cfg(model_ci)
        model = build_model(cfg)
        to_serve = to_serve or (cfg, model)
        ref_cfg = cfg.replace(compute_dtype="float32", use_pallas=False)
        ref = build_model(ref_cfg)
        ref.load_state_dict(model.state_dict())
        # the same bf16 model with the pooling left to plain PyTorch, timed
        # beside the kernel path (what 'auto' chooses for the flagship)
        unfused = build_model(cfg.replace(use_pallas=False))
        unfused.load_state_dict(model.state_dict())
        for batch, bucket in MODEL_BATCHES:
            what = f"flagship {model_ci} {batch}x{bucket}"
            host = ragged_batch(cfg, batch, bucket, rs)
            tensors = to_device(host)
            probs = forward_checked(model, tensors, what)
            check(tuple(probs.shape) == (batch, cfg.num_classes)
                  and bool(torch.isfinite(probs).all()),
                  f"{what}: probs not finite or of the wrong shape")
            with torch.inference_mode():
                want = ref(tensors)["probs"]
            err = float((probs.float() - want).abs().max())
            check(err <= MODEL_ATOL, f"{what}: bf16 kernel path is {err} "
                  f"from the fp32 plain path (tolerance {MODEL_ATOL})")
            # mask-leak probe: garbage in masked rows, probs bit-identical
            for garbage in (1e3, float("nan")):
                dirty = tensors["input_pathology"].clone()
                dirty[~tensors["mask_pathology"]] = garbage
                leaked = forward_checked(
                    model, dict(tensors, input_pathology=dirty), what)
                check(torch.equal(leaked, probs),
                      f"{what}: {garbage} in masked rows changed probs")
                del dirty
            with torch.inference_mode():
                fwd_ms = time_ms(lambda: model(tensors), 10)
                unfused_ms = time_ms(lambda: unfused(tensors), 10)
            lines.append(f"{what}: err_vs_fp32_plain={err:.2e} "
                         f"(tol {MODEL_ATOL}) fwd_ms={fwd_ms:.3f} "
                         f"fwd_ms_plain_pooling={unfused_ms:.3f}")
            del tensors
        del ref, unfused
        torch.cuda.empty_cache()

    # the concat baseline pools the raw 768-d bag: 'auto' turns the kernel on
    cfg = Config(modality=["pathology"], model_family="concat",
                 compute_dtype="bfloat16", use_pallas="auto", seed=SEED)
    concat = build_model(cfg)
    ref = build_model(cfg.replace(compute_dtype="float32", use_pallas=False))
    ref.load_state_dict(concat.state_dict())
    batch, bucket = MODEL_BATCHES[0]
    host = ragged_batch(cfg, batch, bucket, rs)
    del host["input_CI"]
    tensors = to_device(host)
    probs = forward_checked(concat, tensors, "concat baseline")
    with torch.inference_mode():
        want = ref(tensors)["probs"]
    err = float((probs.float() - want).abs().max())
    check(bool(torch.isfinite(probs).all()) and err <= MODEL_ATOL,
          f"concat baseline: {err} from the fp32 plain path")
    lines.append(f"concat baseline {batch}x{bucket} use_pallas=auto: "
                 f"err_vs_fp32_plain={err:.2e}")
    return lines, to_serve


# --------------------------------------------------------------- model-ct --

def ct_cfg(modality, dtype="bfloat16", backend="pallas"):
    """The flagship with a CT branch at full width: MC3-18 (2,2,2,2) trunk,
    full CLIP text tower with ten prompts, TwoWay depth 2, ABMIL pooling,
    three heads when tri-modal."""
    return Config(modality=modality, model_CT="resnetMC3_18",
                  model_pathology="ABMIL", aggregator="ABMIL",
                  loss_point="CT-Pth-Last", model_CI="CLIP",
                  CI_input_version="text", CI_prompt_version="devided",
                  learnablePrompt=1, n_ctx=8, compute_dtype=dtype,
                  ct_temporal_mode="dfold", ct_conv_backend=backend,
                  use_pallas=True, seed=SEED)


def ct_batch(cfg, rs, depth=CT_DEPTH):
    """One patient: a volume in [0, 1), a ragged bag, ten prompts."""
    if "pathology" in cfg.modality:
        out = ragged_batch(cfg, 1, CT_BAG, rs)
    else:
        out = {"input_CI": ragged_batch(cfg, 1, CT_BAG, rs)["input_CI"]}
    hw = cfg.ct_hw
    out["input_CT"] = rs.rand(1, depth, hw, hw, 1).astype(np.float32)
    return out


def ct_forward_checked(model, tensors, what, heads):
    """One forward; conv3x3 must launch 4 times (layer1: 2 blocks x 2
    convolutions) and mil_pool once a head."""
    before = conv3x3.launches, mil_pool.launches
    with torch.inference_mode():
        out = model(tensors)
    torch.cuda.synchronize()
    convs = conv3x3.launches - before[0]
    pools = mil_pool.launches - before[1]
    check(convs == 4 and pools == heads,
          f"{what}: {convs} conv3x3 and {pools} mil_pool launches in one "
          f"forward, expected 4 and {heads}")
    return out


def model_ct_phase():
    rs = np.random.RandomState(SEED + 3)
    lines = []
    to_serve = None
    for modality in (["CT", "pathology"], ["CT"]):
        tri = len(modality) == 2
        heads = ("probs", "probs_CT", "probs_Pth") if tri else ("probs",)
        name = "tri-modal" if tri else "CT-only"
        cfg = ct_cfg(modality)
        host = ct_batch(cfg, rs)
        tensors = to_device(host)
        weights = None
        for dtype in ("bfloat16", "float32"):
            what = f"{name} {dtype}"
            cfg = ct_cfg(modality, dtype)
            model = build_model(cfg)
            if weights is None:
                weights = model.state_dict()
            else:
                model.load_state_dict(weights)
            stock = build_model(ct_cfg(modality, dtype, "xla"))
            stock.load_state_dict(weights)
            if tri and dtype == "bfloat16":
                to_serve = (cfg, model)

            torch.cuda.reset_peak_memory_stats()
            out = ct_forward_checked(model, tensors, what, len(heads))
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            launched = conv3x3.launches
            with torch.inference_mode():
                want = stock(tensors)
                fmap = model.extractor_CT(tensors["input_CT"])
                fmap_stock = stock.extractor_CT(tensors["input_CT"])
            check(conv3x3.launches == launched + 4,
                  f"{what}: the stock route launched conv3x3")
            check(tuple(fmap.shape) == (1, CT_DEPTH, 16, 16, 512),
                  f"{what}: layer4 map has shape {tuple(fmap.shape)}")
            top = float(fmap_stock.float().abs().max())
            spread = float(fmap_stock.float().std())
            zeros = float((fmap_stock == 0).float().mean())
            check(bool(torch.isfinite(fmap).all()) and spread > 1e-3
                  and zeros < 0.99, f"{what}: the layer4 map vanished or "
                  f"overflowed (std {spread}, max {top}, zeros {zeros})")
            tol = CT_TOL[dtype]
            map_err = float((fmap.float() - fmap_stock.float()).abs().max())
            check(map_err <= tol["map_rel"] * top,
                  f"{what}: layer4 map of the kernel route is {map_err} from "
                  f"the stock route's (max {top}, tolerance "
                  f"{tol['map_rel']} of it)")
            errs = []
            for head in heads:
                probs = out[head]
                check(tuple(probs.shape) == (1, cfg.num_classes)
                      and bool(torch.isfinite(probs).all()),
                      f"{what}: {head} not finite or of the wrong shape")
                errs.append(float((probs.float() - want[head].float()
                                   ).abs().max()))
            check(max(errs) <= tol["probs_abs"],
                  f"{what}: heads of the kernel route are {errs} from the "
                  f"stock route's (tolerance {tol['probs_abs']})")
            if tri and dtype == "bfloat16":
                # mask-leak probe through both kernels: NaN in masked rows
                dirty = tensors["input_pathology"].clone()
                dirty[~tensors["mask_pathology"]] = float("nan")
                leaked = ct_forward_checked(
                    model, dict(tensors, input_pathology=dirty), what, 3)
                check(all(torch.equal(leaked[h], out[h]) for h in heads),
                      f"{what}: NaN in masked rows changed the heads")
                del dirty
            with torch.inference_mode():
                fwd_ms = time_ms(lambda: model(tensors), 3, warmup=1)
                stock_ms = time_ms(lambda: stock(tensors), 3, warmup=1)
                trunk_ms = time_ms(
                    lambda: model.extractor_CT(tensors["input_CT"]), 3,
                    warmup=1)
            lines.append(
                f"{what}: map_err {map_err:.3e} (tol {tol['map_rel'] * top:.3e}"
                f"; map std {spread:.4f} max {top:.3f} zeros {zeros:.3f}) "
                f"heads_err {max(errs):.2e} (tol {tol['probs_abs']}) "
                f"fwd_ms {fwd_ms:.2f} fwd_ms_stock_route {stock_ms:.2f} "
                f"trunk_ms {trunk_ms:.2f} peak_GB {peak_gb:.2f}")
            del model, stock, out, want, fmap, fmap_stock
            torch.cuda.empty_cache()
        del tensors
    return lines, to_serve


def serve_ct_phase(cfg, model, pools=3):
    """Serve a tri-modal flagship; a request launches conv3x3 4 times and
    mil_pool ``pools`` times (3 under ABMIL, 0 under TransMIL)."""
    rs = np.random.RandomState(SEED + 4)
    blob = export_model(cfg, model.state_dict(),
                        [make_example_batch(cfg, 1, bag=CT_BAG,
                                            ct_depth=CT_DEPTH)])
    served = ServingModel(blob)
    check(served.device.type == DEV, "ServingModel (CT) is not on the card")
    lines = []
    with InferenceServer(served, host="127.0.0.1", port=0) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        for _ in range(2):
            host = ct_batch(cfg, rs)
            before = conv3x3.launches, mil_pool.launches
            t0 = time.perf_counter()
            code, out = post(f"{base}/predict", host)
            client_ms = (time.perf_counter() - t0) * 1e3
            check(code == 200, f"/predict (CT) answered {code}")
            check(conv3x3.launches == before[0] + 4
                  and mil_pool.launches == before[1] + pools,
                  f"/predict (CT) did not launch conv3x3 4 times and "
                  f"mil_pool {pools} times")
            got = np.asarray(out["probs"], np.float32)
            check(got.shape == (1, cfg.num_classes)
                  and bool(np.isfinite(got).all()), "/predict (CT): bad probs")
            check(np.array_equal(got, served.call(host)),
                  "/predict (CT) differs from ServingModel.call")
            lines.append(f"1x{CT_DEPTH}x512x512 + {CT_BAG} rows device_ms="
                         f"{out['device_ms']} client_ms={client_ms:.0f}")
        try:
            post(f"{base}/predict", ct_batch(cfg, rs, depth=8))
            check(False, "an unknown CT signature was not refused")
        except urllib.error.HTTPError as e:
            msg = json.load(e)["error"]
            check(e.code == 400 and "available" in msg,
                  f"unknown CT signature: {e.code} {msg[:200]}")
    return lines


# ------------------------------------------------------------------ serve --

def post(url, arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(url, data=buf.getvalue())
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.load(r)


def serve_phase(cfg, model):
    rs = np.random.RandomState(SEED + 1)
    signatures = SERVE_SIGNATURES
    blob = export_model(cfg, model.state_dict(),
                        [make_example_batch(cfg, b, bag=n)
                         for b, n in signatures])
    served = ServingModel(blob)
    check(served.device.type == DEV, "ServingModel is not on the card")
    lines = []
    with InferenceServer(served, host="127.0.0.1", port=0) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        for b, n in signatures + signatures[:1]:
            host = ragged_batch(cfg, b, n, rs)
            before = mil_pool.launches
            code, out = post(f"{base}/predict", host)
            check(code == 200, f"/predict {b}x{n} answered {code}")
            check(mil_pool.launches == before + 1,
                  f"/predict {b}x{n} launched the kernel "
                  f"{mil_pool.launches - before} times, expected 1")
            got = np.asarray(out["probs"], np.float32)
            check(got.shape == (b, cfg.num_classes)
                  and bool(np.isfinite(got).all()),
                  f"/predict {b}x{n}: bad probs")
            check(np.array_equal(got, served.call(host)),
                  f"/predict {b}x{n} differs from ServingModel.call")
            with torch.inference_mode():
                direct = model(to_device(host))["probs"].float().cpu().numpy()
            check(np.array_equal(got, direct),
                  f"/predict {b}x{n} differs from the module called directly")
            lines.append(f"{b}x{n} device_ms={out['device_ms']}")
        try:
            post(f"{base}/predict",
                 ragged_batch(cfg, 2, signatures[0][1], rs))
            check(False, "an unknown signature was not refused")
        except urllib.error.HTTPError as e:
            msg = json.load(e)["error"]
            check(e.code == 400 and "available" in msg
                  and all(k in msg.replace("\\n", "\n")
                          for k in served.signatures),
                  f"unknown signature: {e.code} {msg[:200]}")
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.load(r)
        check(health["status"] == "ok" and health["requests"] == 5
              and health["errors"] == 1
              and sorted(health["signatures"]) == sorted(served.signatures),
              f"/healthz: {health}")
    return lines


# ------------------------------------------------------------------ train --

# every kernel's wrapper, by the name of its row in the kernels line
WRAPPERS = {"mil_pool_fwd": mil_pool, "conv3x3_fwd": conv3x3,
            "conv3x3_dgrad": conv3x3_dgrad, "conv3x3_wgrad": conv3x3_wgrad,
            "conv3x3_patch": conv3x3_patch, "conv3x3_tout": conv3x3_tout,
            "conv3x3_wgrad_tout": conv3x3_wgrad_tout}


def counts():
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def zero_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


def only(**launches):
    """Expected counts: these, every other kernel 0."""
    return {name: launches.get(name, 0) for name in WRAPPERS}


def train_cfg(dtype="bfloat16", backend="pallas", batch=TRAIN_BATCH,
              save_dir="results"):
    return ct_cfg(["CT", "pathology"], dtype, backend).replace(
        batch_size=batch, n_epochs=1, log_every=1, num_workers=4,
        save_dir=save_dir, ct_remat="auto")


def dropout_off(model):
    """Training mode with every dropout off (BatchNorm still on its batch
    statistics): the two routes then see the same function."""
    model.train()
    for m in model.modules():
        if isinstance(m, (torch.nn.Dropout, ABMIL)):
            m.eval()


def snapshot(model, names):
    sd = model.state_dict()
    return {k: sd[k].detach().clone() for k in names}


def step_launches(remat):
    """Kernel launches one train step implies: layer1's four convolutions
    run forward once, and again in the backward when stage 1 is
    rematerialised; each has an input and a weight gradient; one mil_pool a
    head (its backward recomputes through the plain version)."""
    fwd = 8 if remat in ("all", "early") else 4
    return only(conv3x3_fwd=fwd, conv3x3_dgrad=4, conv3x3_wgrad=4,
                mil_pool_fwd=3)


def fit_phase(workdir):
    """fit() for one epoch on the synthetic full-width cohort."""
    cfg = train_cfg(save_dir=workdir)
    t0 = time.time()
    syn = SyntheticCohort(cfg, n_per_hospital=TRAIN_PATIENTS,
                          ct_shape=tuple(cfg.ct_shape), bag_range=BAG_RANGE,
                          seed=SEED)
    train_ds, valid_ds = syn.dataset(cfg, "train"), syn.dataset(cfg, "valid")
    cohort_s = time.time() - t0
    sampler = ShardedEpochSampler(len(train_ds), shuffle=True, seed=cfg.seed)
    train_loader = BatchLoader(train_ds, cfg.batch_size, sampler=sampler,
                               num_workers=cfg.num_workers)
    valid_loader = BatchLoader(valid_ds, cfg.batch_size,
                               num_workers=cfg.num_workers)
    state = create_train_state(build_model(cfg), cfg,
                               steps_per_epoch=len(train_loader))
    watched = (LAYER1_GRADS[0], "extractor_CT.model.layer1.0.conv1.1."
               "running_mean", "extractor_CT.model.stem.1.running_var",
               "clinic_extractor.ctx", *HEAD_GRADS)
    before = snapshot(state.model, watched)
    zero_counts()
    t0 = time.time()
    summary = fit(cfg, train_loader, valid_loader, save_dir=workdir,
                  state=state)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    launched = counts()
    tm, vm = summary["train"], summary["valid"]
    check(not summary.get("preempted") and np.isfinite(tm["loss"])
          and np.isfinite(vm["loss"]) and all(
              np.isfinite(tm[k]) for k in ("loss_CT", "loss_Pth",
                                           "loss_Last")),
          f"fit: non-finite losses {tm} {vm}")
    after = snapshot(state.model, watched)
    unchanged = [k for k in watched if torch.equal(before[k], after[k])]
    check(not unchanged, f"fit: unchanged after an epoch: {unchanged}")
    # launches the code implies: steps x a step's, and a forward a
    # validation batch (4 conv3x3, 3 mil_pool)
    remat = "early" if cfg.batch_size >= 2 else "layer2"
    steps, vbatches = tm["n_batches"], vm["n_batches"]
    per_step = step_launches(remat)
    want = {k: steps * v for k, v in per_step.items()}
    want["conv3x3_fwd"] += 4 * vbatches
    want["mil_pool_fwd"] += 3 * vbatches
    check(launched == want, f"fit: launches {launched}, the code implies "
          f"{want} ({steps} steps at ct_remat={remat}, {vbatches} "
          f"validation batches)")
    lines = [f"cohort {len(train_ds)} train / {len(valid_ds)} valid patients "
             f"of 1x{cfg.ct_shape[0]}x{cfg.ct_hw}x{cfg.ct_hw} + "
             f"{BAG_RANGE[0]}-{BAG_RANGE[1] - 1} rows, made in "
             f"{cohort_s:.1f} s; fit {fit_s:.1f} s: {steps} steps at batch "
             f"{cfg.batch_size} (ct_remat {remat}), {vbatches} validation "
             f"batches; train loss {tm['loss']:.4f} (CT {tm['loss_CT']:.4f} "
             f"Pth {tm['loss_Pth']:.4f} Last {tm['loss_Last']:.4f}) "
             f"step_ms {tm['step_ms']:.1f}; valid loss {vm['loss']:.4f} auc "
             f"{vm['auc']:.3f}; launches {launched} = {per_step} a step"]
    return cfg, state, train_loader, lines, launched


def resume_phase(cfg, state, loader, workdir):
    """A checkpoint saved mid-epoch and resumed gives the same next step,
    bit for bit: the uninterrupted state steps on the epoch's second batch,
    then a freshly built model resumes from the checkpoint and steps on the
    batch the loader gives after skip_next(1)."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    step = make_train_step(cfg)
    epoch, bs = 1, cfg.batch_size
    loader.set_epoch(epoch)
    second = [loader.ds.records[int(i)]["patientid"]
              for i in loader.sampler.indices()[bs:2 * bs]]
    loader.skip_next(1)
    batch = loader.first_batch()
    check(list(batch["ID"]) == second,
          f"skip_next(1) gave {batch['ID']}, the epoch's second batch is "
          f"{second}")
    path = ckpt.save_checkpoint(state, workdir, epoch, next_epoch=epoch,
                                batch_in_epoch=1)
    placed = place_batch({k: v for k, v in batch.items() if k != "ID"},
                         torch.device(DEV))
    state, m1 = step(state, placed)
    torch.cuda.synchronize()
    fresh = create_train_state(build_model(cfg, seed=SEED + 7), cfg,
                               steps_per_epoch=len(loader))
    fresh, start_epoch, start_batch = ckpt.resume(fresh, path)
    check((start_epoch, start_batch) == (epoch, 1),
          f"resume gave epoch {start_epoch} batch {start_batch}")
    fresh, m2 = step(fresh, placed)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    check(torch.equal(m1["loss"], m2["loss"]),
          f"resumed step loss {float(m2['loss'])} != {float(m1['loss'])}")
    a, b = state.model.state_dict(), fresh.model.state_dict()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    check(not differ and fresh.step == state.step,
          f"resumed step differs in {len(differ)} tensors: {differ[:5]}")
    return [f"mid-epoch checkpoint (epoch {epoch}, batch 1) resumed: next "
            f"step loss {float(m1['loss']):.6f} both ways, {len(a)} tensors "
            f"and the step counter ({state.step}) bit-identical"]


def watch_conv(model, store):
    """In the next train step, keep the operands (x, k, dy) and the results
    (y, dx, dk) of one layer1 convolution of ``model`` in ``store``.
    Returns the function that undoes this and empties ``store`` (the
    wrapper refers to the module, so without it model and tensors would
    wait for the garbage collector)."""
    conv = model.get_submodule(WATCHED_CONV)
    real = conv._conv2d

    def conv2d(x, k):
        y = real(x, k)
        if "x" not in store:
            store.update(x=x.detach(), k=k.detach(), y=y.detach())
            for name, t in (("dx", x), ("dy", y), ("dk", k)):
                t.register_hook(lambda g, name=name:
                                store.setdefault(name, g.detach()))
        return y

    def unwatch():
        del conv._conv2d
        store.clear()

    conv._conv2d = conv2d
    return unwatch


def held_against_plain(store, dtype, kernel_route):
    """The watched convolution's results against the plain versions on its
    own operands: dk (either route) to the fp64 sum, element by element;
    y and dx (the conv3x3 route's kernels) to CONV_TOL.  Returns the worst
    ratio of error to tolerance of each and checks that it is <= 1."""
    x, k, dy = store["x"], store["k"], store["dy"].to(store["x"].dtype)
    ref = conv3x3_wgrad_plain(x, dy, torch.float64).double()
    mag = conv3x3_wgrad_plain(x.abs(), dy.abs(), torch.float64).double()
    err = (store["dk"].double() - ref).abs()
    tol = STEP_WGRAD_ROUND[dtype] * ref.abs() + STEP_WGRAD_TOL * mag
    out = {"dk_err_over_tol": float((err / tol.clamp_min(1e-300)).max()),
           "dk_err_rel": float(err.max() / ref.abs().max()),
           "dk_cancel": float(mag.max() / ref.abs().max())}
    del ref, mag, err, tol
    if kernel_route:
        for name, got, plain in (
                ("y", store["y"], lambda: conv3x3_plain(x, k)),
                ("dx", store["dx"], lambda: conv3x3_dgrad_plain(dy, k))):
            ref = plain()
            e = float((got.float() - ref.float()).abs().max())
            out[f"{name}_err_over_tol"] = e / (
                CONV_TOL[x.dtype] * float(ref.float().abs().max()))
            del ref
    for name, v in out.items():
        check(not name.endswith("_over_tol") or v <= 1.0,
              f"train step {dtype} {'conv3x3' if kernel_route else 'stock'} "
              f"route: {WATCHED_CONV} {name} {v:.3e} against the plain "
              f"version on its own operands: {out}")
    return out


def route_step_phase(host_batch):
    """One train step at batch 1 from the same weights on the same batch:
    conv3x3 route against the stock route, fp32 (TF32 off) and bf16; then
    step time by CUDA events and peak memory of each; then one more step on
    each route whose layer1 convolution is held against the plain versions
    on its own operands."""
    lines, rows = [], {}
    tensors = place_batch(host_batch, torch.device(DEV))
    weights = None
    for dtype in ("float32", "bfloat16"):
        got = {}
        for backend in ("pallas", "xla"):
            cfg = train_cfg(dtype, backend, batch=1)
            model = build_model(cfg)
            if weights is None:       # a copy: the steps update in place
                weights = {k: v.clone() for k, v in
                           model.state_dict().items()}
            model.load_state_dict(weights)
            state = create_train_state(model, cfg, steps_per_epoch=10)
            dropout_off(model)
            grads = {}
            real_step = state.optimizer.step

            def capture(real_step=real_step, grads=grads, model=model):
                if not grads:
                    named = dict(model.named_parameters())
                    for k in LAYER1_GRADS + HEAD_GRADS:
                        grads[k] = named[k].grad.detach().clone()
                return real_step()

            state.optimizer.step = capture
            step = make_train_step(cfg)
            zero_counts()
            torch.cuda.reset_peak_memory_stats()
            state, m = step(state, tensors)
            torch.cuda.synchronize()
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            launched = counts()
            want = (step_launches("layer2") if backend == "pallas" else
                    only(mil_pool_fwd=3))
            check(launched == want, f"train step {dtype} {backend}: launches "
                  f"{launched}, expected {want}")
            times = []
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, _ = step(state, tensors)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            store = {}
            unwatch = watch_conv(model, store)
            state, _ = step(state, tensors)
            torch.cuda.synchronize()
            held = held_against_plain(store, dtype, backend == "pallas")
            unwatch()
            got[backend] = {"loss": m["loss"].float(), "grads": grads,
                            "ms": float(np.median(times)),
                            "peak_gb": peak_gb, "held": held}
            del state, model, step
            torch.cuda.empty_cache()
        tol = STEP_TOL[dtype]
        k_, s_ = got["pallas"], got["xla"]
        loss_err = float((k_["loss"] - s_["loss"]).abs())
        loss_tol = tol["loss"] * (1.0 if dtype == "bfloat16"
                                  else float(s_["loss"].abs()))
        errs, tops = {}, {}
        for name in LAYER1_GRADS + HEAD_GRADS:
            a, b = k_["grads"][name].float(), s_["grads"][name].float()
            tops[name] = float(b.abs().max())
            errs[name] = float((a - b).abs().max()) / max(tops[name], 1e-30)
            if not bool(torch.isfinite(a).all()):
                errs[name] = float("inf")
        print(f"[train] batch 1 {dtype} gradient errors of their max: "
              f"{json.dumps(errs)}", flush=True)
        check(bool(torch.isfinite(k_["loss"])) and loss_err <= loss_tol,
              f"train step {dtype}: loss {float(k_['loss'])} on the conv3x3 "
              f"route, {float(s_['loss'])} on the stock route (tolerance "
              f"{loss_tol})")
        for name in LAYER1_GRADS:        # read, not held: see STEP_TOL
            check(bool(torch.isfinite(k_["grads"][name]).all()),
                  f"train step {dtype}: non-finite {name} gradient")
        for name in HEAD_GRADS:
            check(tops[name] > 0 and errs[name] <= tol["head_rel"],
                  f"train step {dtype}: {name} gradient {errs[name]:.3e} of "
                  f"its max {tops[name]:.3e} from the stock route's "
                  f"(tolerance {tol['head_rel']})")
        worst_l1 = max(errs[n] for n in LAYER1_GRADS)
        worst_head = max(errs[n] for n in HEAD_GRADS)
        rows[dtype] = {"loss_err": loss_err, "layer1_grad_rel": worst_l1,
                       "head_grad_rel": worst_head,
                       "held_conv3x3": k_["held"], "held_stock": s_["held"],
                       "step_ms": k_["ms"], "step_ms_stock": s_["ms"],
                       "peak_gb": k_["peak_gb"],
                       "peak_gb_stock": s_["peak_gb"]}
        lines.append(
            f"batch 1 {dtype}: loss {float(k_['loss']):.6f} vs stock "
            f"{float(s_['loss']):.6f} (err {loss_err:.2e}, tol "
            f"{loss_tol:.2e}); head grads {worst_head:.2e} of their max (tol "
            f"{tol['head_rel']}); layer1 grads {worst_l1:.2e} apart (read); "
            f"{WATCHED_CONV} against plain on its own operands, conv3x3 "
            f"route {json.dumps(k_['held'])}, stock route "
            f"{json.dumps(s_['held'])}; "
            f"step_ms {k_['ms']:.1f} stock {s_['ms']:.1f} (median of 3); "
            f"peak_GB {k_['peak_gb']:.2f} stock {s_['peak_gb']:.2f}")
    del tensors
    return lines, rows


def train_phase():
    """fit() with the counts at 0 just before and read just after (the
    main path); then the resume and route checks, whose launches do not
    count."""
    workdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        cfg, state, loader, lines, launched = fit_phase(workdir)
        batch1 = BatchLoader(loader.ds, 1, prefetch=0).first_batch()
        batch1 = {k: v for k, v in batch1.items() if k != "ID"}
        lines += resume_phase(cfg, state, loader, workdir)
        del state, loader
        torch.cuda.empty_cache()
        route_lines, route_rows = route_step_phase(batch1)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return lines + route_lines, launched, route_rows


# --------------------------------------------------------- model-transmil --
# The paper's default flagship: aggregator and model_pathology TransMIL, the
# configuration of tests/test_golden.py at published widths (MC3-18, CLIP
# text tower 49408 / 77 / 512 / 8 heads / 12 layers with ten prompts, TwoWay
# depth 2, three heads), bf16.  Its pooling runs no kernel (Nyström attention
# is plain products); its trunk runs conv3x3 four times a forward.  Routes
# held as the ABMIL flagship's are, to CT_TOL: the heads of the conv3x3 route
# against the stock route in the same type.  Pathology-only TransMIL in fp32
# on the card against the same module on the CPU: only the order of sums
# differs -> PATH_TRANSMIL_ATOL on probabilities.
PATH_TRANSMIL_ATOL = 1e-4
PATH_TRANSMIL_BAG = 16384


# res_conv's weight gradient (models/transmil.py::_ResConv) on the card, in
# fp32 at the bag length the 8192 bucket gives TransMIL (91 x 91 + the cls
# token = 8282 tokens, front-padded to 8448), against an fp64 evaluation of
# dW[h, t] = sum v_pad[b, h, n + t, d] * g[b, h, n, d] on the same v and g:
# fp32 sums of 0.5M products of operands exact in fp32 -> <= 1e-5 * max|dW|.
RES_CONV_TOL = 1e-5


def res_conv_check():
    """One fp32 backward through a TransLayer-sized NystromSelfAttention on
    the card; returns res_conv.weight.grad's error, its tolerance and the
    padded token count."""
    from llmmil_tpu_torch.models.transmil import NystromSelfAttention
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    n_tok = int(np.ceil(np.sqrt(CT_BAG))) ** 2 + 1
    mod = NystromSelfAttention(dim=512, heads=8, dim_head=64,
                               num_landmarks=256).to(DEV).eval()
    with torch.no_grad():
        for p in mod.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=DEV) * 0.05)
    kept = {}

    def keep_v(_, __, qkv):               # v: the last third of to_qkv's
        kept["v"] = qkv[..., 1024:].detach()

    def keep_out(_, args):                # res_conv's output joins here
        args[0].retain_grad()
        kept["out"] = args[0]

    mod.to_qkv.register_forward_hook(keep_v)
    mod.to_out[0].register_forward_pre_hook(keep_out)
    x = torch.randn(1, n_tok, 512, generator=gen, device=DEV)
    out, _ = mod(x)
    (out * torch.randn(out.shape, generator=gen, device=DEV)).sum().backward()
    padded = kept["v"].shape[1]
    v = kept["v"].reshape(1, padded, 8, 64).transpose(1, 2).double()
    g = kept["out"].grad.reshape(1, padded, 8, 64).transpose(1, 2).double()
    vp = F.pad(v, (0, 0, 16, 16))
    want = torch.stack([(vp[:, :, t:t + padded] * g).sum((0, 2, 3))
                        for t in range(33)], -1)[:, None, :, None]
    err = float((mod.res_conv.weight.grad.double() - want).abs().max())
    tol = RES_CONV_TOL * float(want.abs().max())
    check(padded == 8448 and err <= tol, f"res_conv weight gradient at "
          f"{padded} tokens: {err} from fp64 (tolerance {tol})")
    return err, tol, padded


def transmil_cfg(modality, dtype="bfloat16", backend="pallas"):
    return ct_cfg(modality, dtype, backend).replace(
        model_pathology="TransMIL", aggregator="TransMIL")


def model_transmil_phase():
    rs = np.random.RandomState(SEED + 9)
    heads = ("probs", "probs_CT", "probs_Pth")
    modality = ["CT", "pathology"]
    tensors = to_device(ct_batch(transmil_cfg(modality), rs))
    lines, weights, to_serve = [], None, None
    for dtype in ("bfloat16", "float32"):
        what = f"tri-modal TransMIL {dtype}"
        cfg = transmil_cfg(modality, dtype)
        model = build_model(cfg)
        if weights is None:
            weights = model.state_dict()
        else:
            model.load_state_dict(weights)
        stock = build_model(transmil_cfg(modality, dtype, "xla"))
        stock.load_state_dict(weights)
        torch.cuda.reset_peak_memory_stats()
        out = ct_forward_checked(model, tensors, what, 0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        launched = conv3x3.launches
        with torch.inference_mode():
            want = stock(tensors)
        check(conv3x3.launches == launched,
              f"{what}: the stock route launched conv3x3")
        tol = CT_TOL[dtype]["probs_abs"]
        errs = []
        for head in heads:
            check(tuple(out[head].shape) == (1, cfg.num_classes)
                  and bool(torch.isfinite(out[head]).all()),
                  f"{what}: {head} not finite or of the wrong shape")
            errs.append(float((out[head].float() - want[head].float()
                               ).abs().max()))
        check(max(errs) <= tol, f"{what}: heads of the kernel route are "
              f"{errs} from the stock route's (tolerance {tol})")
        leak = ""
        if dtype == "bfloat16":
            to_serve = (cfg, model)
            for garbage in (1e3, float("nan")):
                dirty = tensors["input_pathology"].clone()
                dirty[~tensors["mask_pathology"]] = garbage
                leaked = ct_forward_checked(
                    model, dict(tensors, input_pathology=dirty), what, 0)
                check(all(torch.equal(leaked[h], out[h]) for h in heads),
                      f"{what}: {garbage} in masked rows changed the heads")
                del dirty, leaked
            leak = "; 1e3 and NaN in masked rows: heads bit-identical"
        with torch.inference_mode():
            fwd_ms = time_ms(lambda: model(tensors), 3, warmup=1)
            stock_ms = time_ms(lambda: stock(tensors), 3, warmup=1)
        lines.append(f"{what}: heads_err {max(errs):.2e} (tol {tol}) "
                     f"probs {out['probs'].float().cpu().numpy().tolist()} "
                     f"fwd_ms {fwd_ms:.2f} fwd_ms_stock_route {stock_ms:.2f} "
                     f"peak_GB {peak_gb:.2f}{leak}")
        if dtype != "bfloat16":
            del model
        del stock, out, want
        torch.cuda.empty_cache()
    del tensors
    return lines, to_serve


def serve_transmil_pathology():
    """Pathology-only TransMIL (CLIP prompts) at 1 x 16384 rows: exported,
    served over HTTP, each answer the module's; the same module in fp32 on
    the card against the CPU."""
    rs = np.random.RandomState(SEED + 10)
    cfg = flagship_cfg("CLIP").replace(model_pathology="TransMIL",
                                       aggregator="TransMIL")
    model = build_model(cfg)
    bag = PATH_TRANSMIL_BAG
    served = ServingModel(export_model(cfg, model.state_dict(),
                                       [make_example_batch(cfg, 1, bag=bag)]))
    lines = []
    with InferenceServer(served, host="127.0.0.1", port=0) as srv:
        base = f"http://127.0.0.1:{srv.port}"
        for _ in range(2):
            host = ragged_batch(cfg, 1, bag, rs)
            before = counts()
            code, out = post(f"{base}/predict", host)
            check(code == 200, f"/predict (TransMIL) answered {code}")
            check(counts() == before,
                  "/predict (pathology TransMIL) launched a kernel")
            got = np.asarray(out["probs"], np.float32)
            check(got.shape == (1, cfg.num_classes)
                  and bool(np.isfinite(got).all()),
                  "/predict (TransMIL): bad probs")
            with torch.inference_mode():
                direct = model(to_device(host))["probs"].float().cpu().numpy()
            check(np.array_equal(got, direct),
                  "/predict (TransMIL) differs from the module called "
                  "directly")
            lines.append(f"pathology TransMIL 1x{bag} device_ms="
                         f"{out['device_ms']}")
    tensors = to_device(host)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(tensors), 5, warmup=1)
    fp32 = build_model(cfg.replace(compute_dtype="float32"))
    fp32.load_state_dict(model.state_dict())
    cpu = build_model(cfg.replace(compute_dtype="float32"), device="cpu")
    cpu.load_state_dict(model.state_dict())
    with torch.inference_mode():
        on_card = fp32(tensors)["probs"].cpu()
        on_cpu = cpu({k: torch.from_numpy(v) for k, v in host.items()}
                     )["probs"]
    err = float((on_card - on_cpu).abs().max())
    check(bool(torch.isfinite(on_card).all()) and err <= PATH_TRANSMIL_ATOL,
          f"pathology TransMIL fp32: card {on_card.tolist()} against CPU "
          f"{on_cpu.tolist()} (tolerance {PATH_TRANSMIL_ATOL})")
    bf16_err = float((torch.from_numpy(direct) - on_cpu).abs().max())
    lines.append(f"pathology TransMIL 1x{bag} bf16 fwd_ms {fwd_ms:.2f}; fp32 "
                 f"card vs CPU {err:.2e} (tol {PATH_TRANSMIL_ATOL}); bf16 vs "
                 f"fp32 CPU {bf16_err:.2e} (read, not held)")
    return lines


# ---------------------------------------------------------- bench-conv3x3 --

BENCH_TIMEOUT_S = 600


def bench_phase():
    """The conv3x3 bench entry point at the path's shape, few iterations, in
    a process of its own: it must exit 0 with every mode's parity lines and
    time rows; its last line carries its kernels' launch counts."""
    modes, wgrad_modes = ("taps", "patch", "tout"), ("taps", "tout")
    cmd = [sys.executable, "-m", "llmmil_tpu_torch.eval.bench_conv3x3",
           "--iters", "3", "--reps", "2", "--modes", ",".join(modes)]
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        if line.strip():
            print(f"[bench-conv3x3] {line}", flush=True)
    check(proc.returncode == 0, f"bench_conv3x3 exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    want = [f"parity {m}: fwd" for m in modes] + \
        [f"parity {m}: dx" for m in modes] + \
        [f"parity wgrad {m}: dw" for m in wgrad_modes] + \
        [f"kernel fwd {m} " for m in modes] + \
        [f"kernel dgrad {m} " for m in modes] + \
        [f"kernel wgrad {m} " for m in wgrad_modes] + \
        ["library fwd", "library dgrad", "library wgrad"]
    missing = [w for w in want if not any(
        line.startswith(w) and "FAILED" not in line for line in lines)]
    check(not missing, f"bench_conv3x3: rows missing or failed: {missing}")
    last = json.loads(lines[-1])
    check(not last["failed"], f"bench_conv3x3: failed rows {last['failed']}")
    launched = {name: last["launches"].get(name, 0) for name in WRAPPERS}
    return launched, time.time() - t0


# ------------------------------------------------------------------- main --

WGMMA_LIBRARIES = ("mil_pool", "conv3x3", "conv3x3_tout", "conv3x3_patch",
                   "conv3x3_wgrad", "conv3x3_wgrad_tout")


def sass_line(name, lib):
    """The library's bf16 kernels run on wgmma: its SASS holds HGMMA and no
    HMMA (mma.sync), where the toolkit has cuobjdump."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(cuobjdump):
        return f"{name} SASS: not read (no cuobjdump)"
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    hgmma, hmma = sass.count("HGMMA."), sass.count("HMMA.")
    check(hgmma > 0 and hmma == 0, f"{name}'s SASS holds {hgmma} HGMMA and "
          f"{hmma} HMMA: its bf16 kernel is not on wgmma")
    return f"{name} SASS: {hgmma} HGMMA, {hmma} HMMA"


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 1
    # cuBLAS gives the same bits run to run only with a fixed workspace;
    # read when its handle is made, at the first product
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(f"[device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} devices {torch.cuda.device_count()} tf32 off",
          flush=True)

    t0 = time.time()
    names = ("mil_pool", "conv3x3", "conv3x3_wgrad", "conv3x3_patch",
             "conv3x3_tout", "conv3x3_wgrad_tout")   # one nvcc each, all
    # started together
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(
            lambda name: build.build_library(name, verbose=True), names))
    torch.zeros(1, device=DEV)
    print(f"[build] {', '.join(lib.name for lib in libs)} for sm_90a in "
          f"{time.time() - t0:.1f} s", flush=True)
    for name in WGMMA_LIBRARIES:
        print(f"[build] {sass_line(name, libs[names.index(name)])}",
              flush=True)

    shapes = kernels_phase()
    compared = mil_pool.launches
    for s in shapes:
        print(f"[kernels] mil_pool_fwd {s['shape']}: pooled_err "
              f"{s['pooled_err']:.2e} (tol {s['pooled_tol']:.2e}) attn_err "
              f"{s['attn_err']:.2e} (tol {s['attn_tol']:.2e}) ms {s['ms']:.4f} "
              f"plain_ms {s['plain_ms']:.4f} bound_ms {s['bound_ms']:.4f} "
              f"({s['bound_by']})"
              + (f"; same bits twice; {s['plan']}" if "plan" in s else ""),
              flush=True)
    conv_shapes = conv_kernels_phase()
    conv_compared = conv3x3.launches
    for s in conv_shapes:
        print(f"[kernels] conv3x3_fwd {s['shape']}: err {s['err']:.2e} "
              f"(tol {s['tol']:.2e}; same bits twice {s['same_bits']}; "
              f"F.conv2d err {s['library_err']:.2e}; "
              f"{s['differs_from_plain']} of {s['elements']} values differ "
              f"from plain, {s['differs_from_library']} from F.conv2d) "
              f"ms {s['ms']:.4f} plain_ms {s['plain_ms']:.4f} library_ms "
              f"{s['library_ms']:.4f} bound_ms {s['bound_ms']:.4f} "
              f"({s['bound_by']})", flush=True)

    bwd_rows = conv_bwd_phase()
    for r in bwd_rows:
        print(f"[kernels-bwd] {r['shape']}: dgrad err {r['dgrad_err']:.2e} "
              f"(tol {r['dgrad_tol']:.2e}; cuDNN {r['dgrad_library_err']:.2e}"
              f"; same bits twice {r['dgrad_same_bits']}) ms {r['dgrad_ms']:.4f} plain_ms {r['dgrad_plain_ms']:.4f} "
              f"library_ms {r['dgrad_library_ms']:.4f} bound_ms "
              f"{r['dgrad_bound_ms']:.4f} ({r['dgrad_bound_by']}) | wgrad "
              f"err vs fp64 {r['wgrad_err']:.2e} (tol {r['wgrad_tol']:.2e}; "
              f"cuDNN {r['wgrad_library_err']:.2e}, plain fp32 "
              f"{r['wgrad_plain_fp32_err']:.2e}) same bits twice "
              f"{r['wgrad_same_bits']} ms {r['wgrad_ms']:.4f} plain_ms "
              f"{r['wgrad_plain_ms']:.4f} library_ms "
              f"{r['wgrad_library_ms']:.4f} bound_ms "
              f"{r['wgrad_bound_ms']:.4f} ({r['wgrad_bound_by']}) | wgrad "
              f"tout err vs fp64 {r['wgrad_tout_err']:.2e} same bits twice "
              f"{r['wgrad_tout_same_bits']} ms {r['wgrad_tout_ms']:.4f}",
              flush=True)
    bwd_compared = counts()
    mode_rows = modes_phase()
    print_modes(mode_rows)
    modes_compared = counts()

    # the main paths: every count to 0 just before, read just after
    zero_counts()
    model_lines, (cfg, model) = model_phase()
    for line in model_lines:
        print(f"[model] {line}", flush=True)
    serve_lines = serve_phase(cfg, model)
    print(f"[serve] {'; '.join(serve_lines)}", flush=True)
    del model
    torch.cuda.empty_cache()
    check(conv3x3.launches == 0, "the pathology path launched conv3x3")
    ct_lines, (cfg, model) = model_ct_phase()
    for line in ct_lines:
        print(f"[model-ct] {line}", flush=True)
    serve_ct_lines = serve_ct_phase(cfg, model)
    print(f"[serve-ct] {'; '.join(serve_ct_lines)}", flush=True)
    serve_launched = counts()
    check(serve_launched["mil_pool_fwd"] > 0,
          "the serving paths never launched mil_pool")
    check(serve_launched["conv3x3_fwd"] >= 4,
          "the CT serving path never launched conv3x3")
    check(serve_launched["conv3x3_dgrad"] == serve_launched["conv3x3_wgrad"]
          == 0, "the serving paths launched a gradient kernel")
    del model
    torch.cuda.empty_cache()

    train_lines, train_launched, route_rows = train_phase()   # zeroes counts
    for line in train_lines:
        print(f"[train] {line}", flush=True)
    for k in ("conv3x3_fwd", "conv3x3_dgrad", "conv3x3_wgrad",
              "mil_pool_fwd"):
        check(train_launched[k] > 0, f"the training path never launched {k}")
    # the paper's default flagship, TransMIL, served
    zero_counts()
    tm_lines, (cfg, model) = model_transmil_phase()
    for line in tm_lines:
        print(f"[model-transmil] {line}", flush=True)
    err, tol, padded = res_conv_check()
    print(f"[model-transmil] res_conv weight gradient, fp32, {padded} tokens: "
          f"err vs fp64 {err:.2e} (tol {tol:.2e})", flush=True)
    tm_serve_lines = serve_ct_phase(cfg, model, pools=0)
    del model
    torch.cuda.empty_cache()
    tm_serve_lines += serve_transmil_pathology()
    print(f"[serve-transmil] {'; '.join(tm_serve_lines)}", flush=True)
    transmil_launched = counts()
    check(transmil_launched == only(
        conv3x3_fwd=transmil_launched["conv3x3_fwd"])
        and transmil_launched["conv3x3_fwd"] >= 4,
        f"the TransMIL paths launched {transmil_launched}: conv3x3's forward "
        "kernel and nothing else")
    torch.cuda.empty_cache()

    # the conv3x3 bench entry point, in a process of its own (its counts
    # start at 0 there and come back on its last line)
    bench_launched, bench_s = bench_phase()
    print(f"[bench-conv3x3] {bench_s:.1f} s, launches {bench_launched}",
          flush=True)
    for k in ("conv3x3_fwd", "conv3x3_dgrad", "conv3x3_wgrad",
              "conv3x3_patch", "conv3x3_tout", "conv3x3_wgrad_tout"):
        check(bench_launched[k] > 0, f"the bench entry point never launched "
              f"{k}")

    by_path = {"serve": serve_launched, "train": train_launched,
               "transmil": transmil_launched, "bench": bench_launched}
    launched = {k: sum(p[k] for p in by_path.values()) for k in WRAPPERS}
    launches = launched["mil_pool_fwd"]
    conv_launches = launched["conv3x3_fwd"]

    head = next(s for s in shapes if s["shape"].startswith(
        "x".join(map(str, HEADLINE_SHAPE[:3]))))
    conv_head = conv_shapes[CONV_SHAPES.index(CONV_HEADLINE)]
    kernels = [{
        "name": "mil_pool_fwd", "route": "cuda",
        "source": "llmmil_tpu_torch/csrc/mil_pool.cu",
        "replaces": "llmmil_tpu/ops/pallas/mil_pool.py:130",
        "launches": launches,
        "max_abs_err": max(max(s["pooled_err"], s["attn_err"])
                           for s in shapes),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,     # no single PyTorch call computes this
        "timed_at": head["shape"], "comparison_launches": compared,
        "shapes": shapes,
    }, {
        "name": "conv3x3_fwd", "route": "cuda",
        "source": "llmmil_tpu_torch/csrc/conv3x3.cu",
        "replaces": "llmmil_tpu/ops/pallas/conv3x3.py:148",
        "launches": conv_launches,
        "max_abs_err": max(s["err"] for s in conv_shapes),
        "ms": conv_head["ms"], "plain_ms": conv_head["plain_ms"],
        "bound_ms": conv_head["bound_ms"], "bound_by": conv_head["bound_by"],
        "library_ms": conv_head["library_ms"],   # F.conv2d, channels_last
        "timed_at": conv_head["shape"],
        "comparison_launches": conv_compared, "shapes": conv_shapes,
    }]
    bwd_head = bwd_rows[0]
    for which, source, replaces in (
            ("dgrad", "llmmil_tpu_torch/csrc/conv3x3.cu",
             "llmmil_tpu/ops/pallas/conv3x3.py:293"),
            ("wgrad", "llmmil_tpu_torch/csrc/conv3x3_wgrad.cu",
             "llmmil_tpu/ops/pallas/conv3x3.py:250")):
        name = f"conv3x3_{which}"
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched[name],
            "max_abs_err": max(r[f"{which}_err"] for r in bwd_rows),
            "ms": bwd_head[f"{which}_ms"],
            "plain_ms": bwd_head[f"{which}_plain_ms"],
            "bound_ms": bwd_head[f"{which}_bound_ms"],
            "bound_by": bwd_head[f"{which}_bound_by"],
            "library_ms": bwd_head[f"{which}_library_ms"],   # cuDNN
            "timed_at": bwd_head["shape"],
            "comparison_launches": bwd_compared[name],
            "shapes": [{k: v for k, v in r.items()
                        if k == "shape" or (k.startswith(which)
                                            and not k.startswith("wgrad_tout"))}
                       for r in bwd_rows]})
    path_row = mode_rows[0]
    for name, source, replaces, key in (
            ("conv3x3_patch", "llmmil_tpu_torch/csrc/conv3x3_patch.cu",
             "llmmil_tpu/ops/pallas/conv3x3.py:71", "patch"),
            ("conv3x3_tout", "llmmil_tpu_torch/csrc/conv3x3_tout.cu",
             "llmmil_tpu/ops/pallas/conv3x3.py:86", "tout")):
        fwd = path_row[f"fwd_{key}"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launched[name],
            "max_abs_err": max(max(r[f"fwd_{key}"]["err"],
                                   r[f"dgrad_{key}"]["err"])
                               for r in mode_rows),
            "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
            "bound_ms": path_row["fwd_bound_ms"],
            "bound_by": path_row["fwd_bound_by"],
            "library_ms": path_row["fwd_library_ms"],   # F.conv2d
            "dgrad_ms": path_row[f"dgrad_{key}"]["ms"],
            **({"kernel_ms": fwd["kernel_ms"],         # yT, no transpose
                "dgrad_kernel_ms": path_row["dgrad_tout"]["kernel_ms"],
                "transpose_ms": fwd["transpose_ms"],   # yT back to NHWC
                "dgrad_transpose_ms": path_row["dgrad_tout"]["transpose_ms"]}
               if key == "tout" else {}),
            "dgrad_library_ms": path_row["dgrad_library_ms"],
            "timed_at": path_row["shape"],
            "comparison_launches": modes_compared[name],
            "shapes": [{k: v for k, v in r.items() if k == "shape"
                        or key in k or k.endswith(("taps_ms", "library_ms"))}
                       for r in mode_rows]})
    wt = path_row["wgrad_tout"]
    kernels.append({
        "name": "conv3x3_wgrad_tout", "route": "cuda",
        "source": "llmmil_tpu_torch/csrc/conv3x3_wgrad_tout.cu",
        "replaces": "llmmil_tpu/ops/pallas/conv3x3.py:194",
        "launches": launched["conv3x3_wgrad_tout"],
        "max_abs_err": max([r["wgrad_tout"]["err"] for r in mode_rows]
                           + [r["wgrad_tout_err"] for r in bwd_rows]),
        "ms": wt["ms"], "plain_ms": wt["plain_ms"],
        "bound_ms": wt["bound_ms"], "bound_by": wt["bound_by"],
        "library_ms": wt["library_ms"],                 # conv2d_weight
        "timed_at": path_row["shape"],
        "comparison_launches": modes_compared["conv3x3_wgrad_tout"],
        "shapes": [{"shape": r["shape"], **r["wgrad_tout"]}
                   for r in mode_rows] +
                  [{"shape": r["shape"], "err": r["wgrad_tout_err"],
                    "tol": r["wgrad_tol"],
                    "same_bits": r["wgrad_tout_same_bits"],
                    "ms": r["wgrad_tout_ms"],
                    "library_ms": r["wgrad_library_ms"],
                    "bound_ms": r["wgrad_bound_ms"]} for r in bwd_rows]})
    for k in kernels:
        k["launches_by_path"] = {p: c[k["name"]] for p, c in by_path.items()}
    print(f"[done] {time.time() - t_start:.1f} s, main-path launches "
          f"(serve + train + transmil + bench): {launched}; train step on "
          f"both routes: {json.dumps(route_rows)}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
