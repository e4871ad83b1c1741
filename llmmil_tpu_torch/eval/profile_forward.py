"""Where a forward (or a train step) of the flagship spends its time on the
card.

``python -m llmmil_tpu_torch.eval.profile_forward [--model_ci CLIP]
[--batch 8] [--bag 8192] [--no_kernel] [--ct tri|only] [--ct_depth 160]
[--ct_conv_backend pallas|xla] [--aggregator ABMIL|TransMIL] [--train]``
builds the flagship at full width with seeded random weights (the pathology
model, or with ``--ct`` the tri-modal or the CT-only one on 512 x 512 slices;
pooled by ABMIL or by the paper's default TransMIL), runs a few forwards under
``torch.profiler`` and prints one JSON line: the card, milliseconds per
forward on the host's clock, the device's busy milliseconds per forward (sum
of kernel times), its idle share, the number of kernels per forward, the
kernels that take the most time and, with ``--ct``, the span on the device
of each part of the model (trunk, clinical encoder, fusion, pooling), from
its first kernel's start to its last kernel's end.  ``--train`` profiles
train steps instead (forward, multi-head loss, backward, SGD update;
``ct_remat`` resolved for the batch, dropout on): the same keys, per step,
with the forward's parts labelled (the backward runs outside them).  It
needs a CUDA card.
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
    p.add_argument("--ct", default="", choices=["", "tri", "only"],
                   help="profile the tri-modal or the CT-only flagship")
    p.add_argument("--ct_depth", type=int, default=160)
    p.add_argument("--ct_conv_backend", default="pallas",
                   choices=["pallas", "xla"])
    p.add_argument("--aggregator", default="ABMIL",
                   choices=["ABMIL", "TransMIL"],
                   help="the MIL aggregator (and model_pathology): ABMIL, "
                        "or the paper's default TransMIL")
    p.add_argument("--train", action="store_true",
                   help="profile train steps instead of forwards")
    args = p.parse_args(argv)

    kw = dict(modality=["pathology"], model_pathology=args.aggregator,
              aggregator=args.aggregator, loss_point="Last",
              compute_dtype="bfloat16", use_pallas=not args.no_kernel)
    if args.model_ci == "CLIP":
        kw.update(model_CI="CLIP", CI_input_version="text",
                  CI_prompt_version="devided", learnablePrompt=1)
    else:
        kw.update(model_CI="simpleFCs_v1", learnablePrompt=0)
    if args.ct:
        kw.update(modality=["CT", "pathology"] if args.ct == "tri"
                  else ["CT"], model_CT="resnetMC3_18",
                  loss_point="CT-Pth-Last", ct_temporal_mode="dfold",
                  ct_conv_backend=args.ct_conv_backend)
    if args.train:
        kw.update(batch_size=args.batch, ct_remat="auto")
    cfg = Config(**kw)
    model = build_model(cfg)                 # raises without a card
    rs = np.random.RandomState(0)
    host = make_example_batch(cfg, args.batch, bag=args.bag,
                              ct_depth=args.ct_depth)
    if "input_pathology" in host:
        host["input_pathology"] = rs.randn(
            *host["input_pathology"].shape).astype(np.float32)
        host["mask_pathology"] = np.arange(args.bag)[None] < rs.randint(
            args.bag // 2, args.bag + 1, (args.batch, 1))
    if "input_CT" in host:
        host["input_CT"] = rs.rand(*host["input_CT"].shape).astype(np.float32)
    if args.train:
        host["label"] = np.eye(cfg.num_classes, dtype=np.float32)[
            rs.randint(0, cfg.num_classes, args.batch)]
    tensors = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    parts = _label_parts(model) if args.ct else []
    if args.train:
        from ..train import create_train_state, make_train_step
        from ..config import resolve_memory_config
        cfg = resolve_memory_config(cfg, training=True)
        state = create_train_state(model, cfg, steps_per_epoch=100)
        train_step = make_train_step(cfg)

        def run():
            train_step(state, tensors)
    else:
        def run():
            with torch.inference_mode():
                model(tensors)

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.iters
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.iters):
            run()
        torch.cuda.synchronize()
    for handle in parts:
        handle.remove()
    on_device = [e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
    # a labelled part shows on the device as one range from its first
    # kernel's start to its last kernel's end: a span, not a kernel
    kernels = [e for e in on_device if not e.name.startswith("part:")]
    by_part: dict[str, float] = {}
    for e in on_device:
        if e.name.startswith("part:"):
            by_part[e.name[5:]] = by_part.get(e.name[5:], 0.0) \
                + e.device_time / 1e3 / args.iters
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
        f"bf16 {args.aggregator} kernel={'off' if args.no_kernel else 'on'}"
        + (
            f" ct={args.ct} depth={args.ct_depth} "
            f"conv={args.ct_conv_backend}" if args.ct else "") + (
            f" train ct_remat={cfg.ct_remat}" if args.train else ""),
        "per": "train step" if args.train else "forward",
        "wall_ms_per_forward": wall_ms,
        "device_busy_ms_per_forward": busy_ms,
        "device_idle_share": (max(0.0, 1.0 - busy_ms / wall_ms)
                              if busy_ms else None),
        "kernels_per_forward": len(kernels) / args.iters,
        "top_kernels_ms_per_forward": [
            {"name": name[:80], "ms": ms / args.iters,
             "calls": n / args.iters} for name, (ms, n) in top],
    }
    if by_part:
        out["device_span_ms_by_part"] = by_part
    print(json.dumps(out), flush=True)
    return out


def _label_parts(model):
    """Wrap the model's top-level parts in ``record_function`` ranges, so
    that the profile sums device time by part; returns the hook handles."""
    names = {"extractor_CT": "trunk", "clinic_extractor": "clinical encoder",
             "TwoWayTransformer_Both": "fusion",
             "TwoWayTransformer_CT": "fusion",
             "TwoWayTransformer_Pth": "fusion", "aggregator": "pooling"}
    handles, open_ranges = [], {}
    for name, part in names.items():
        module = getattr(model, name, None)
        if module is None:
            continue

        def enter(mod, args, part=part):
            rng = torch.profiler.record_function("part:" + part)
            rng.__enter__()
            open_ranges.setdefault(id(mod), []).append(rng)

        def leave(mod, args, output):
            open_ranges[id(mod)].pop().__exit__(None, None, None)

        handles.append(module.register_forward_pre_hook(enter))
        handles.append(module.register_forward_hook(leave))
    return handles


if __name__ == "__main__":
    main()
