"""The bf16 weight-gradient kernel's pixel-range length and tile height
against its time and its accuracy, on the card.

``python -m llmmil_tpu_torch.eval.probe_wgrad_ranges [--slices 160,320]
[--iters 20] [--rounds 3]`` builds ``csrc/conv3x3_wgrad.cu`` once for each
variant of ``VARIANTS`` — the shipped design and copies of the sources whose
``conv3x3_sm90.cuh`` sets another tile height, stage count or range length
— runs each at (N, 128, 128, 192) → 64 bf16, MC3 layer1's shape, holds its
dw against an fp64 sum of the same operands (the error as a share of
``chip_smoke.py``'s tolerance, 1e-4 of max |dw|) and times the variants in
turns by CUDA events, the order reversed every other round.  It prints one
JSON line with the card.  It needs a CUDA card and ``nvcc``.

A range's sums are chains of ``wgmma`` accumulations; how long a chain may
be before its rounding matters is what the range length trades against
the number of partials and of units a block walks.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops.kernels import build, conv3x3_wgrad_plain
from .probe_conv3x3 import _launcher

# the lines of conv3x3_sm90.cuh a variant rewrites, as they stand
TH_LINE = "constexpr int TH = 4, TW = 64;"
STAGES_LINE = "constexpr int STAGES = 2;"
RANGE_LINE = "constexpr long long MAX_RANGE_TILES = 32768 / (TH * TW);"
VARIANTS = {           # name: (tile rows, stages, pixels a range at most)
    "shipped": (4, 2, 32768),
    "range_65536": (4, 2, 65536),
    "range_16384": (4, 2, 16384),
    "th3_3_stages": (3, 3, 32768),
    "th2_4_stages": (2, 4, 32768),
}


def variant_header(text: str, th: int, stages: int, pixels: int) -> str:
    """conv3x3_sm90.cuh with the weight-gradient kernel's tile height, stage
    count and range length replaced; raises if a line has moved."""
    for line in (TH_LINE, STAGES_LINE, RANGE_LINE):
        if text.count(line) != 1:
            raise RuntimeError(f"conv3x3_sm90.cuh no longer holds {line!r}")
    return (text.replace(TH_LINE, f"constexpr int TH = {th}, TW = 64;")
            .replace(STAGES_LINE, f"constexpr int STAGES = {stages};")
            .replace(RANGE_LINE, "constexpr long long MAX_RANGE_TILES = "
                                 f"{pixels} / (TH * TW);"))


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--slices", default="160,320",
                   help="the N of (N, 128, 128, 192), comma-separated")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--rounds", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_wgrad_ranges needs a CUDA card")
    header = (build.CSRC_DIR / "conv3x3_sm90.cuh").read_text()
    out = {"variants": {k: {"tile_rows": v[0], "stages": v[1],
                            "range_pixels": v[2]}
                        for k, v in VARIANTS.items()}, "shapes": []}
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, (th, stages, pixels) in VARIANTS.items():
            src = Path(tmp) / name
            shutil.copytree(build.CSRC_DIR, src)
            (src / "conv3x3_sm90.cuh").write_text(
                variant_header(header, th, stages, pixels))
            procs[name] = subprocess.Popen(       # one nvcc each, together
                [build._find_nvcc(), *build.NVCC_FLAGS, "-o",
                 str(src / "lib.so"), str(src / "conv3x3_wgrad.cu")])
        libs = {}
        for name, proc in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed on the {name} build")
            libs[name] = ctypes.CDLL(str(Path(tmp) / name / "lib.so"))
        stream = torch.cuda.current_stream().cuda_stream
        gen = torch.Generator(device="cuda").manual_seed(11)
        for n in map(int, args.slices.split(",")):
            shape = (n, 128, 128, 192, 64)
            x = torch.randn(shape[:4], generator=gen, device="cuda").to(
                torch.bfloat16)
            dy = torch.randn(shape[:3] + (64,), generator=gen,
                             device="cuda").to(torch.bfloat16)
            ref = conv3x3_wgrad_plain(x, dy, torch.float64)
            tol = 1e-4 * float(ref.abs().max())
            calls, errs = {}, {}
            for name, lib in libs.items():
                dw = torch.empty(3, 3, 192, 64, device="cuda")
                calls[name] = _launcher(lib, "conv3x3_wgrad", (x, dy, dw),
                                        shape, 1, stream)
                if calls[name]():
                    raise RuntimeError(f"{name}: the launch failed")
                torch.cuda.synchronize()
                errs[name] = float((dw.double() - ref).abs().max()) / tol
            times = {name: [] for name in libs}
            for r in range(args.rounds):
                for name in (list(libs) if r % 2 == 0 else list(libs)[::-1]):
                    for _ in range(3):
                        calls[name]()
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(args.iters):
                        calls[name]()
                    end.record()
                    torch.cuda.synchronize()
                    times[name].append(start.elapsed_time(end) / args.iters)
            out["shapes"].append({"shape": list(shape),
                                  "err_over_tol": errs, "ms": times})
            del x, dy, ref
            torch.cuda.empty_cache()
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
