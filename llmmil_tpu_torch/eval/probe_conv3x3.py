"""Which phase bounds a ``conv3x3`` kernel on the card.

``python -m llmmil_tpu_torch.eval.probe_conv3x3 [--kernel taps|tout|patch|
wgrad|wgrad_tout] [--shape 160,128,128,192,64] [--dtype bfloat16]`` builds
the kernel's source (``csrc/conv3x3.cu``, ``conv3x3_tout.cu``,
``conv3x3_patch.cu``, ``conv3x3_wgrad.cu`` or ``conv3x3_wgrad_tout.cu``)
several times, each build skipping one phase through the source's
``CONV3X3_SKIP_*`` macros (the loads of x or of the second operand — k for
a forward kernel, dy for a weight gradient — after a tile's first chunk or
a range's first tile, the products, the stores; for bf16: the producer
warp's TMA boxes, the consumers' ``wgmma``, the TMA stores or the stores of
the partials), times every build at one shape by CUDA events and prints one
JSON line with the card.  The tout kernel is timed alone, without the
wrapper's transpose of yᵀ back to NHWC; a weight gradient with its
planning entry called first, a workspace, and the fixed-order sum of the
partials.  The skipping builds compute garbage: only their times mean
something.  A
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

VARIANTS = {          # {w}: the second operand, k or dy
    "full": (),
    "no_{w}_loads": ("W",),
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
    "wgrad": ("conv3x3_wgrad", "conv3x3_wgrad"),
    "wgrad_tout": ("conv3x3_wgrad_tout", "conv3x3_wgrad_tout"),
}
_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_WGRAD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_SPLITS_ARGS = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]


def _launcher(lib, entry, tensors, shape, code, stream):
    """A call of the kernel in library ``lib`` on ``tensors`` at ``shape``
    (N, H, W, C, F): a forward with x, k and its output; a weight gradient
    with x, dy, the workspace its planning entry asks for and dw."""
    fn = getattr(lib, entry)
    wgrad = entry.startswith("conv3x3_wgrad")
    fn.argtypes, fn.restype = (_WGRAD_ARGS if wgrad else _FWD_ARGS), \
        ctypes.c_int
    if not wgrad:
        x, k, y = tensors
        return lambda: fn(x.data_ptr(), k.data_ptr(), y.data_ptr(), *shape,
                          code, stream)
    plan = getattr(lib, entry + "_splits")
    plan.argtypes, plan.restype = _SPLITS_ARGS, ctypes.c_int
    splits = ctypes.c_int(0)
    err = plan(*shape, code, ctypes.byref(splits))
    if err:
        raise RuntimeError(f"{entry}_splits: CUDA error {err}")
    x, dy, dw = tensors
    n, h, w, c, f = shape
    ws = torch.empty(splits.value * 9 * c * f, dtype=torch.float32,
                     device="cuda")
    return lambda: fn(x.data_ptr(), dy.data_ptr(), ws.data_ptr(),
                      dw.data_ptr(), *shape, splits.value, code, stream)


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
    if args.kernel.startswith("wgrad"):
        dy = torch.randn(n, h, w, f, generator=gen, device="cuda").to(dtype)
        tensors = (x, dy, torch.empty(9 * c * f, device="cuda"))
    else:
        k = (torch.randn(3, 3, c, f, generator=gen, device="cuda")
             * (9 * c) ** -0.5).to(dtype)
        tensors = (x, k, torch.empty(n * h * w * f, dtype=dtype,
                                     device="cuda"))          # y or yᵀ
    second = "dy" if args.kernel.startswith("wgrad") else "k"
    code = 0 if dtype == torch.float32 else 1
    stream = torch.cuda.current_stream().cuda_stream

    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        source, entry = KERNELS[args.kernel]
        src = str(build.CSRC_DIR / f"{source}.cu")
        procs = {name.format(w=second): subprocess.Popen(   # one nvcc
            [build._find_nvcc(), *build.NVCC_FLAGS,         # each, together
             *(f"-DCONV3X3_SKIP_{m}" for m in skip),
             "-o", f"{tmp}/{name.format(w=second)}.so", src])
            for name, skip in VARIANTS.items()}
        for name, proc in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed on the {name} build")
            call = _launcher(ctypes.CDLL(f"{tmp}/{name}.so"), entry, tensors,
                             (n, h, w, c, f), code, stream)

            def run():
                err = call()
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
