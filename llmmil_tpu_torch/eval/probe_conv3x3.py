"""Which phase bounds a ``conv3x3`` kernel on the card.

``python -m llmmil_tpu_torch.eval.probe_conv3x3 [--kernel taps|tout|patch]
[--shape 160,128,128,192,64] [--dtype bfloat16]`` builds the kernel's
source (``csrc/conv3x3.cu``, ``conv3x3_tout.cu`` or ``conv3x3_patch.cu``)
several times, each build skipping one phase through the source's
``CONV3X3_SKIP_*`` macros (the loads of x or of k after a tile's first
chunk, the products, the stores; for bf16: the producer warp's TMA boxes,
the consumers' ``wgmma``, the TMA stores), times every build at one shape by
CUDA events and prints one JSON line with the card.  The tout kernel is
timed alone, without the wrapper's transpose of yᵀ back to NHWC.  The
skipping builds compute garbage: only their times mean something.  A
profiler that reads the card's counters would say more; this works where
none runs.  It needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile

import torch

from ..ops.kernels import build

VARIANTS = {
    "full": (),
    "no_k_loads": ("W",),
    "no_x_loads": ("X",),
    "no_loads": ("W", "X"),
    "no_products": ("MMA",),
    "no_stores": ("STORE",),
    "loads_only": ("MMA", "STORE"),
    "products_only": ("W", "X", "STORE"),
}
KERNELS = {            # --kernel: (source, C entry point)
    "taps": ("conv3x3", "conv3x3_fwd"),
    "tout": ("conv3x3_tout", "conv3x3_tout_fwd"),
    "patch": ("conv3x3_patch", "conv3x3_patch_fwd"),
}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--kernel", default="taps", choices=sorted(KERNELS))
    p.add_argument("--shape", default="160,128,128,192,64",
                   help="N,H,W,C,F")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_conv3x3 needs a CUDA card")
    n, h, w, c, f = map(int, args.shape.split(","))
    dtype = getattr(torch, args.dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, h, w, c, generator=gen, device="cuda").to(dtype)
    k = (torch.randn(3, 3, c, f, generator=gen, device="cuda")
         * (9 * c) ** -0.5).to(dtype)
    y = torch.empty(n * h * w * f, dtype=dtype, device="cuda")   # y or yᵀ
    code = 0 if dtype == torch.float32 else 1
    stream = torch.cuda.current_stream().cuda_stream

    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        source, entry = KERNELS[args.kernel]
        src = str(build.CSRC_DIR / f"{source}.cu")
        procs = {name: subprocess.Popen(          # one nvcc each, together
            [build._find_nvcc(), *build.NVCC_FLAGS,
             *(f"-DCONV3X3_SKIP_{m}" for m in skip),
             "-o", f"{tmp}/{name}.so", src])
            for name, skip in VARIANTS.items()}
        for name, proc in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed on the {name} build")
            fwd = getattr(ctypes.CDLL(f"{tmp}/{name}.so"), entry)
            fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 \
                + [ctypes.c_void_p]
            fwd.restype = ctypes.c_int

            def run():
                err = fwd(x.data_ptr(), k.data_ptr(), y.data_ptr(), n, h, w,
                          c, f, code, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(args.iters):
                run()
            end.record()
            torch.cuda.synchronize()
            times[name] = start.elapsed_time(end) / args.iters
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": card, "shape": [n, h, w, c, f], "dtype": args.dtype,
           "ms": times, "kernel": args.kernel}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
