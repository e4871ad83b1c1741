#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``llmmil_tpu_torch``) on one NVIDIA
Hopper card: ``python3 chip_smoke.py``.

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card, drives the port's
main path — the pathology + clinical-information flagship at full width,
built, called and served over HTTP — and checks that the path went through
the kernels.  Any failed phase ends the run with a non-zero exit; without a
CUDA card it exits non-zero at once.  The weights are random, made from a
seed.  Phases, one line each:

  device   card name and power limit (nvidia-smi), torch and CUDA versions
  build    nvcc over llmmil_tpu_torch/csrc, seconds taken
  kernels  one JSON line: every kernel against its plain version, with times
  model    build_model → forward, bf16 kernel path against fp32 plain path
  serve    export_model → ServingModel → InferenceServer, HTTP requests
  last     {"ok": true, "device": {...}}
"""

import io
import json
import subprocess
import sys
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from llmmil_tpu_torch import Config
from llmmil_tpu_torch.data.bags import bucket_for, pad_bag
from llmmil_tpu_torch.eval.export import (ServingModel, export_model,
                                          make_example_batch)
from llmmil_tpu_torch.eval.serve import InferenceServer
from llmmil_tpu_torch.models import build_model
from llmmil_tpu_torch.ops.kernels import build, mil_pool, mil_pool_plain

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

KERNEL_SHAPES = [            # (B, N, L, dtype); N+1 / N+10: the flagship
    (8, 8192, 768, torch.bfloat16),     # joins the CI tokens to the bag
    (8, 16384, 768, torch.bfloat16),
    (1, 8193, 512, torch.bfloat16),
    (8, 8193, 512, torch.bfloat16),
    (8, 8202, 512, torch.bfloat16),
    (1, 16385, 512, torch.bfloat16),
    (1, 16394, 512, torch.bfloat16),
    (2, 700, 256, torch.float32),
    (2, 130, 256, torch.float32),
]
HEADLINE_SHAPE = KERNEL_SHAPES[0]
MODEL_BATCHES = ((8, 8192), (1, 16384))           # (batch, bag bucket)
SERVE_SIGNATURES = ((1, 8192), (1, 16384), (8, 8192))
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
    lib = build.build_library("mil_pool", verbose=True)
    torch.zeros(1, device=DEV)
    print(f"[build] {lib.name} for sm_90a in {time.time() - t0:.1f} s",
          flush=True)

    shapes = kernels_phase()
    compared = mil_pool.launches
    for s in shapes:
        print(f"[kernels] mil_pool_fwd {s['shape']}: pooled_err "
              f"{s['pooled_err']:.2e} (tol {s['pooled_tol']:.2e}) attn_err "
              f"{s['attn_err']:.2e} (tol {s['attn_tol']:.2e}) ms {s['ms']:.4f} "
              f"plain_ms {s['plain_ms']:.4f} bound_ms {s['bound_ms']:.4f} "
              f"({s['bound_by']})", flush=True)

    # the main path: every count to 0 just before, read just after
    mil_pool.launches = 0
    model_lines, (cfg, model) = model_phase()
    for line in model_lines:
        print(f"[model] {line}", flush=True)
    serve_lines = serve_phase(cfg, model)
    launches = mil_pool.launches
    print(f"[serve] {'; '.join(serve_lines)}", flush=True)
    check(launches > 0, "the main path never launched mil_pool")

    head = next(s for s in shapes if s["shape"].startswith(
        "x".join(map(str, HEADLINE_SHAPE[:3]))))
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
    }]
    print(f"[done] {time.time() - t_start:.1f} s, main-path launches "
          f"{launches}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
