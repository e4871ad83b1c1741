"""conv3x3's kernels in every mode against the library's convolutions at MC3
layer1's shape, op by op: ``python -m llmmil_tpu_torch.eval.bench_conv3x3``.

The port of ``scripts/bench_conv3x3.py``, with its flags::

    [--n 160] [--hw 128] [--c 192] [--f 64] [--iters 20] [--reps 5]
    [--modes taps,patch,tout] [--dtype bfloat16] [--ops fwd,dgrad,wgrad]
    [--small] [--device cuda|cpu] [--block-h ...]

  fwd    y  = conv(x, w)                 (N,H,W,C)→F
  dgrad  dx = conv(g, rot(w))            (N,H,W,F)→C   (the gradient wrt x)
  wgrad  dw = Σ patchesᵀ(x)·g            → (3,3,C,F)   (the gradient wrt w)

The library rows are the card's own calls (cuDNN): ``F.conv2d`` on a
channels_last view, ``torch.nn.grad.conv2d_input`` and ``conv2d_weight``,
with TF32 off so that an fp32 reference is fp32.  The kernel rows are the
port's ``ops/kernels/conv3x3.py`` in each mode (``taps``: nine tap products
over a staged halo patch; ``patch``: one K = 9C product over im2col tiles;
``tout``: the transposed product, turned back to NHWC), and the weight
gradient in ``taps`` and ``tout``.  Parity lines come first: each mode's
forward and input gradient, and both weight gradients, against the
library's, each with its tolerance.  Then the times: CUDA events around
``--iters`` calls after a warm-up, the best of ``--reps``, with TFLOP/s and
the share of the H100's dense bf16 peak (989 TFLOP/s).  The JAX script's
chained loop only kept XLA from hoisting the op; eager calls need none.

The TPU kernels' ``--block-h`` row block has no counterpart: the port's
kernels pick their own tiles, and each row's label names the tile that ran.
A value for it is refused rather than ignored.

``--device cpu`` (with ``--small``: 4 x 32 x 32 x 16 → 8, fp32) runs the
kernels' plain versions and times them on the host's clock, which says
nothing about a device.  A row that fails (it raises, or a parity line is
over its tolerance) prints FAILED, and the script exits 1 once every row
has run.  The last line is one JSON object: the device, the kernels' launch
counts in this process, the failed rows.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from ..ops.kernels import (WGRAD_MODES, conv3x3, conv3x3_dgrad, conv3x3_fwd,
                           conv3x3_patch, conv3x3_tout, conv3x3_wgrad,
                           conv3x3_wgrad_tout)

PEAK = 989e12        # H100 SXM, dense bf16, at its 700 W limit
# The tile each kernel runs (csrc/*.cu), by type: what a row's label names.
TILES = {
    ("taps", torch.bfloat16): "8x64 px x 64 ch, halo chunks of 16 ch, "
                              "wgmma",
    ("taps", torch.float32): "8x16 px x 32 ch, halo chunks of 16 ch",
    ("patch", torch.bfloat16): "256 px x 64 ch (F > 64: 128 px x 192 ch), "
                               "TMA im2col chunks of 64 ch, wgmma",
    ("patch", torch.float32): "64 px x 64 ch, im2col K-chunks of 16",
    ("tout", torch.bfloat16): "64 ch x 8x64 px, halo chunks of 16 ch, "
                              "wgmma",
    ("tout", torch.float32): "64 ch x 64 px, im2col K-chunks of 16",
    ("wgrad taps", torch.bfloat16): "ranges of <=128 4x64-px tiles, 64 ch "
                                    "x 64, halo of 64 ch, wgmma",
    ("wgrad taps", torch.float32): "ranges of <=128 8x16-px tiles, "
                                   "(tap, 32 ch) x 64",
    ("wgrad tout", torch.bfloat16): "ranges of <=128 4x64-px tiles, 64 x 64 "
                                    "ch, halo of 64 ch, wgmma",
    ("wgrad tout", torch.float32): "ranges of <=16384 px, 64 x (tap, 64 "
                                   "ch), steps of 32 px",
}
# Kernel against library, relative to the library's largest |value|.  Both
# sides round the same inputs and sum in fp32: a forward or input gradient
# in bf16 may differ by one bf16 step (2^-7 of the largest value at most);
# the library's bf16 weight gradient is itself rounded to bf16 (2^-8) on top
# of sums of 2.6M products in another order.  fp32 (TF32 off): the orders of
# the sums only, but cuDNN may pick transform-based algorithms -> 1e-4.
TOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-4}


def lib_fwd(x, w):
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def lib_dgrad(g, w):
    n, h, wd, _ = g.shape
    shape = (n, w.shape[2], h, wd)
    return torch.nn.grad.conv2d_input(shape, w.permute(3, 2, 0, 1),
                                      g.permute(0, 3, 1, 2),
                                      padding=1).permute(0, 2, 3, 1)


def lib_wgrad(g, x):
    shape = (g.shape[-1], x.shape[-1], 3, 3)
    return torch.nn.grad.conv2d_weight(x.permute(0, 3, 1, 2), shape,
                                       g.permute(0, 3, 1, 2),
                                       padding=1).permute(2, 3, 1, 0)


def launch_counts():
    """The kernels' launch counters in this process."""
    return {"conv3x3_fwd": conv3x3.launches,
            "conv3x3_dgrad": conv3x3_dgrad.launches,
            "conv3x3_wgrad": conv3x3_wgrad.launches,
            "conv3x3_patch": conv3x3_patch.launches,
            "conv3x3_tout": conv3x3_tout.launches,
            "conv3x3_wgrad_tout": conv3x3_wgrad_tout.launches}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=160)
    p.add_argument("--hw", type=int, default=128)
    p.add_argument("--c", type=int, default=192)
    p.add_argument("--f", type=int, default=64)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--block-h", type=str, default="",
                   help="the TPU kernels' row block: refused, the port's "
                        "kernels pick their own tiles (named in each row)")
    p.add_argument("--modes", type=str, default="taps,patch,tout")
    p.add_argument("--dtype", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--ops", type=str, default="fwd,dgrad,wgrad")
    p.add_argument("--small", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the default) or cpu (the plain versions)")
    ns = p.parse_args(argv)
    if ns.block_h:
        p.error(f"--block-h {ns.block_h}: the port's kernels pick their own "
                "tiles (each row names its tile); there is no row block to "
                "set")
    if ns.small:
        ns.n, ns.hw, ns.c, ns.f, ns.iters, ns.reps = 4, 32, 16, 8, 3, 2
        ns.dtype = "float32"
    return ns


def main(argv=None) -> int:
    ns = parse_args(argv)
    device = torch.device(ns.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("bench_conv3x3: no CUDA device; pass --device cpu "
                           "to run the plain versions on the host")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dt = getattr(torch, ns.dtype)
    modes, ops = ns.modes.split(","), ns.ops.split(",")
    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        print(f"device {card} | torch {torch.__version__} cuda "
              f"{torch.version.cuda} | tf32 off", flush=True)
    else:
        card = "cpu"
        print("device cpu: the kernels' plain versions, timed on the host's "
              "clock (no device metric)", flush=True)

    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(ns.n, ns.hw, ns.hw, ns.c, generator=gen,
                    device=device).to(dt)
    w = (torch.randn(3, 3, ns.c, ns.f, generator=gen, device=device)
         * 0.05).to(dt)
    g = torch.randn(ns.n, ns.hw, ns.hw, ns.f, generator=gen,
                    device=device).to(dt)
    flops = 2 * ns.n * ns.hw * ns.hw * 9 * ns.c * ns.f
    failed = []

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def parity(label, got_fn, want):
        try:
            got = got_fn()
            sync()
            top = float(want.float().abs().max())
            err = float((got.float() - want.float()).abs().max())
            tol = TOL[dt] * top
            ok = err <= tol and bool(torch.isfinite(got).all())
            print(f"parity {label}: max|Δ| {err:.3e} (tol {tol:.3e}, "
                  f"{TOL[dt]:.1e} of max|library| {top:.3e})"
                  f"{'' if ok else '  FAILED'}", flush=True)
            if not ok:
                failed.append(f"parity {label}")
        except Exception as e:       # a failed row is reported, not hidden
            print(f"parity {label}: FAILED {type(e).__name__}: "
                  f"{str(e)[:200]}", flush=True)
            failed.append(f"parity {label}")

    def timed(label, fn):
        try:
            fn()
            sync()
            best = float("inf")
            for _ in range(ns.reps):
                if on_card:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    for _ in range(ns.iters):
                        fn()
                    end.record()
                    torch.cuda.synchronize()
                    ms = start.elapsed_time(end) / ns.iters
                else:
                    t0 = time.perf_counter()
                    for _ in range(ns.iters):
                        fn()
                    ms = (time.perf_counter() - t0) * 1e3 / ns.iters
                best = min(best, ms)
            if on_card:
                tf = flops / (best / 1e3)
                print(f"{label:<74} {best:>9.4f} ms {tf / 1e12:>7.1f} "
                      f"TFLOP/s {100 * tf / PEAK:>5.1f}% of the H100 bf16 "
                      "peak", flush=True)
            else:
                print(f"{label:<74} {best:>9.4f} ms on the host's clock",
                      flush=True)
        except Exception as e:
            print(f"{label:<74} FAILED {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
            failed.append(label)

    # parity against the library's calls (fwd, dx of each mode; both wgrads)
    want, want_dx, want_dw = lib_fwd(x, w), lib_dgrad(g, w), lib_wgrad(g, x)
    sync()
    for mode in modes:
        parity(f"{mode}: fwd", lambda: conv3x3_fwd(x, w, mode), want)
        parity(f"{mode}: dx", lambda: conv3x3_dgrad(g, w, mode), want_dx)
    for wm in WGRAD_MODES:
        parity(f"wgrad {wm}: dw", lambda: conv3x3_wgrad(x, g, wm), want_dw)
    del want, want_dx, want_dw

    print(f"\nshape ({ns.n},{ns.hw},{ns.hw},{ns.c})->{ns.f} {ns.dtype}, "
          f"{flops / 1e9:.0f} GFLOP/op", flush=True)
    if "fwd" in ops:
        timed("library fwd (F.conv2d, channels_last)", lambda: lib_fwd(x, w))
    if "dgrad" in ops:
        timed("library dgrad (conv2d_input)", lambda: lib_dgrad(g, w))
    if "wgrad" in ops:
        timed("library wgrad (conv2d_weight)", lambda: lib_wgrad(g, x))
    for mode in modes:
        tile = TILES.get((mode, dt), "?")
        if "fwd" in ops:
            timed(f"kernel fwd {mode} [{tile}]",
                  lambda: conv3x3_fwd(x, w, mode))
        if "dgrad" in ops:
            timed(f"kernel dgrad {mode} [{tile}]",
                  lambda: conv3x3_dgrad(g, w, mode))
    if "wgrad" in ops:
        for wm in WGRAD_MODES:
            timed(f"kernel wgrad {wm} [{TILES[('wgrad ' + wm, dt)]}]",
                  lambda: conv3x3_wgrad(x, g, wm))

    print(json.dumps({"device": card, "launches": launch_counts(),
                      "failed": failed}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
