#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llmmil_tpu_torch``) on one NVIDIA
Hopper card: ``python3 chip_smoke.py``.

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card, drives the port's
main paths — the pathology + clinical-information flagship and the tri-modal
flagship with its CT trunk, each at full width, built, called and served over
HTTP — and checks that the paths went through the kernels.  Any failed phase
ends the run with a non-zero exit; without a CUDA card it exits non-zero at
once.  The weights are random, made from a seed.  Phases:

  device    card name and power limit (nvidia-smi), torch and CUDA versions
  build     nvcc over llmmil_tpu_torch/csrc (all sources at once), seconds
  kernels   every kernel against its plain version at every shape, with times
  model     build_model → forward, bf16 kernel path against fp32 plain path
  serve     export_model → ServingModel → InferenceServer, HTTP requests
  model-ct  the tri-modal and the CT-only flagship on one 160 x 512 x 512
            volume: conv3x3 kernel route against the stock route, same type
  serve-ct  the tri-modal flagship exported and served over HTTP
  last      one JSON line for the kernels, the card, {"ok": true, ...}
"""

import concurrent.futures
import io
import json
import subprocess
import sys
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
from llmmil_tpu_torch.models import build_model
from llmmil_tpu_torch.ops.kernels import (build, conv3x3, conv3x3_plain,
                                          mil_pool, mil_pool_plain)

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
CONV_SHAPES = [              # (N, H, W, C, F, dtype)
    (160, 128, 128, 192, 64, torch.bfloat16),   # MC3 layer1, dfold: the path
    (16, 128, 128, 192, 64, torch.float32),     # the same in fp32, 16 slices
    (16, 128, 128, 64, 192, torch.bfloat16),    # dshift
    (16, 128, 128, 64, 64, torch.bfloat16),     # dsum
    (2, 33, 31, 20, 70, torch.bfloat16),        # ragged everywhere
    (2, 10, 16, 8, 4, torch.float32),
    (3, 17, 13, 24, 40, torch.float32),
]
CONV_HEADLINE = CONV_SHAPES[0]
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

def kernel_inputs(b, n, l, dtype, gen):
    dev = DEV
    x = torch.randn(b, n, l, generator=gen, device=dev).to(dtype)
    n_valid = torch.randint(n // 2, n + 1, (b, 1), generator=gen, device=dev)
    mask = torch.arange(n, device=dev)[None] < n_valid
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
    for b, n, l, dtype in KERNEL_SHAPES:
        x, mask, params = kernel_inputs(b, n, l, dtype, gen)
        pooled, attn, rec = compare_mil_pool(x, mask, params)
        name = f"{b}x{n}x{l} {str(dtype).split('.')[-1]}"
        check(rec["pooled_err"] <= rec["pooled_tol"]
              and rec["attn_err"] <= rec["attn_tol"],
              f"mil_pool disagrees with its plain version at {name}: {rec}")

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
        torch.cuda.synchronize()
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
                       "library_err": lib_err,
                       "differs_from_library": off_library,
                       "differs_from_plain": int((ref != y).sum()),
                       "elements": y.numel(), "ms": ms,
                       "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by})
        del x, y, ref
        torch.cuda.empty_cache()
    return shapes


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


def serve_ct_phase(cfg, model):
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
                  and mil_pool.launches == before[1] + 3,
                  "/predict (CT) did not launch conv3x3 4 times and "
                  "mil_pool 3 times")
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


# ------------------------------------------------------------------- main --

def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the card only", file=sys.stderr)
        return 1
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
    names = ("mil_pool", "conv3x3")         # one nvcc each, started together
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(
            lambda name: build.build_library(name, verbose=True), names))
    torch.zeros(1, device=DEV)
    print(f"[build] {', '.join(lib.name for lib in libs)} for sm_90a in "
          f"{time.time() - t0:.1f} s", flush=True)

    shapes = kernels_phase()
    compared = mil_pool.launches
    for s in shapes:
        print(f"[kernels] mil_pool_fwd {s['shape']}: pooled_err "
              f"{s['pooled_err']:.2e} (tol {s['pooled_tol']:.2e}) attn_err "
              f"{s['attn_err']:.2e} (tol {s['attn_tol']:.2e}) ms {s['ms']:.4f} "
              f"plain_ms {s['plain_ms']:.4f} bound_ms {s['bound_ms']:.4f} "
              f"({s['bound_by']})", flush=True)
    conv_shapes = conv_kernels_phase()
    conv_compared = conv3x3.launches
    for s in conv_shapes:
        print(f"[kernels] conv3x3_fwd {s['shape']}: err {s['err']:.2e} "
              f"(tol {s['tol']:.2e}; F.conv2d err {s['library_err']:.2e}; "
              f"{s['differs_from_plain']} of {s['elements']} values differ "
              f"from plain, {s['differs_from_library']} from F.conv2d) "
              f"ms {s['ms']:.4f} plain_ms {s['plain_ms']:.4f} library_ms "
              f"{s['library_ms']:.4f} bound_ms {s['bound_ms']:.4f} "
              f"({s['bound_by']})", flush=True)

    # the main paths: every count to 0 just before, read just after
    mil_pool.launches = 0
    conv3x3.launches = 0
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
    launches = mil_pool.launches
    conv_launches = conv3x3.launches
    check(launches > 0, "the main paths never launched mil_pool")
    check(conv_launches >= 4, "the CT path never launched conv3x3")

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
    print(f"[done] {time.time() - t_start:.1f} s, main-path launches: "
          f"mil_pool {launches}, conv3x3 {conv_launches}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
