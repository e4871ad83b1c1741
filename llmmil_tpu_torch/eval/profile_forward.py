"""Where a forward of the pathology flagship spends its time on the card.

``python -m llmmil_tpu_torch.eval.profile_forward [--model_ci CLIP]
[--batch 8] [--bag 8192] [--no_kernel]`` builds the flagship at full width
with seeded random weights, runs a few forwards under ``torch.profiler`` and
prints one JSON line: the card, milliseconds per forward on the host's
clock, the device's busy milliseconds per forward (sum of kernel times), its
idle share, the number of kernels per forward and the kernels that take the
most time.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..config import Config
from ..models import build_model
from .export import make_example_batch


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model_ci", default="simpleFCs_v1",
                   choices=["simpleFCs_v1", "CLIP"])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--bag", type=int, default=8192)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--no_kernel", action="store_true",
                   help="leave the pooling to plain PyTorch")
    p.add_argument("--top", type=int, default=8)
    args = p.parse_args(argv)

    kw = dict(modality=["pathology"], model_pathology="ABMIL",
              aggregator="ABMIL", loss_point="Last",
              compute_dtype="bfloat16", use_pallas=not args.no_kernel)
    if args.model_ci == "CLIP":
        kw.update(model_CI="CLIP", CI_input_version="text",
                  CI_prompt_version="devided", learnablePrompt=1)
    else:
        kw.update(model_CI="simpleFCs_v1", learnablePrompt=0)
    cfg = Config(**kw)
    model = build_model(cfg)                 # raises without a card
    rs = np.random.RandomState(0)
    host = make_example_batch(cfg, args.batch, bag=args.bag)
    host["input_pathology"] = rs.randn(
        *host["input_pathology"].shape).astype(np.float32)
    host["mask_pathology"] = np.arange(args.bag)[None] < rs.randint(
        args.bag // 2, args.bag + 1, (args.batch, 1))
    tensors = {k: torch.from_numpy(v).cuda() for k, v in host.items()}

    with torch.inference_mode():
        for _ in range(3):
            model(tensors)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.iters):
            model(tensors)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.iters):
                model(tensors)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, list[float]] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.device_time / 1e3
        rec[1] += 1
    busy_ms = sum(v[0] for v in by_name.values()) / args.iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:args.top]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {
        "card": card, "config": f"{args.model_ci} {args.batch}x{args.bag} "
        f"bf16 kernel={'off' if args.no_kernel else 'on'}",
        "wall_ms_per_forward": wall_ms,
        "device_busy_ms_per_forward": busy_ms,
        "device_idle_share": (max(0.0, 1.0 - busy_ms / wall_ms)
                              if busy_ms else None),
        "kernels_per_forward": len(kernels) / args.iters,
        "top_kernels_ms_per_forward": [
            {"name": name[:80], "ms": ms / args.iters,
             "calls": n / args.iters} for name, (ms, n) in top],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
