"""Which phase bounds the bf16 ``mil_pool`` kernel on the card.

``python -m llmmil_tpu_torch.eval.probe_mil_pool [--shapes 8,8192,768;1,8202,512]
[--iters 50]`` builds ``csrc/mil_pool.cu`` several times, each build skipping
one phase through the source's ``MIL_POOL_SKIP_*`` macros (every TMA load;
the consumers' ``wgmma`` and the logits' transcendentals; the pooling pass,
its loads and its sums; the joins after the grid barrier; everything
after the set-up, which leaves the launch and the scan of the mask), times
every build at each shape by CUDA events over
a CUDA graph of back-to-back launches of its C entry point (no wrapper, no
host time between launches: the kernel's time) and prints one JSON line
with the card.  The bags are drawn as
``chip_smoke.py`` draws them (each bag's valid rows a prefix of N/2 to N
rows).  The skipping builds compute garbage: only their times mean
something.  It needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile

import torch

from ..ops.kernels import build
from ..ops.kernels.mil_pool import GATE_WIDTH, _Launcher, pack_gates

VARIANTS = {             # name: the macros of its build
    "full": (),
    "products_only": ("MIL_POOL_SKIP_LOADS",),
    "loads_only": ("MIL_POOL_SKIP_MMA", "MIL_POOL_SKIP_POOL"),
    "no_products": ("MIL_POOL_SKIP_MMA",),
    "no_pool": ("MIL_POOL_SKIP_POOL",),
    "no_join": ("MIL_POOL_SKIP_JOIN",),
    "setup_only": ("MIL_POOL_SETUP_ONLY",),
}


def _inputs(b, n, l, gen):
    dev = "cuda"
    x = torch.randn(b, n, l, generator=gen, device=dev).to(torch.bfloat16)
    n_valid = torch.randint(n // 2, n + 1, (b, 1), generator=gen, device=dev)
    mask = torch.arange(n, device=dev)[None] < n_valid
    d = GATE_WIDTH
    wv, wu = (torch.randn(l, d, generator=gen, device=dev) * 0.05
              for _ in range(2))
    small = [torch.randn(d, generator=gen, device=dev) * 0.05
             for _ in range(3)] + [torch.randn(1, generator=gen, device=dev)]
    return x, mask, pack_gates(wv, wu), small


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--shapes", default="8,8192,768;1,8202,512",
                   help="B,N,L;B,N,L...")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--variants", default=",".join(VARIANTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_mil_pool needs a CUDA card")
    shapes = [tuple(map(int, s.split(","))) for s in args.shapes.split(";")]
    names = args.variants.split(",")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"shapes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        src = str(build.CSRC_DIR / "mil_pool.cu")
        procs = {name: subprocess.Popen(                     # one nvcc each,
            [build._find_nvcc(), *build.NVCC_FLAGS,           # all together
             *(f"-D{m}" for m in VARIANTS[name]), "-o", f"{tmp}/{name}.so",
             src]) for name in names}
        libs = {}
        for name, proc in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"nvcc failed on the {name} build")
            libs[name] = _Launcher(ctypes.CDLL(f"{tmp}/{name}.so"))
        for b, n, l in shapes:
            x, mask, gates, (bv, bu, ww, bw) = _inputs(b, n, l, gen)
            pooled = torch.empty(b, l, device="cuda")
            attn = torch.empty(b, n, device="cuda")
            times, plans = {}, {}
            for name, k in libs.items():
                scratch, barrier = k.scratch(b, n, l, 1, x.device, stream)
                plans[name] = k.plan(b, n)

                def run():
                    err = k.fwd(x.data_ptr(), mask.data_ptr(),
                                gates.data_ptr(), None, bv.data_ptr(),
                                bu.data_ptr(), ww.data_ptr(), bw.data_ptr(),
                                pooled.data_ptr(), attn.data_ptr(),
                                scratch.data_ptr(), barrier.data_ptr(), b, n,
                                l, GATE_WIDTH, 1, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                for _ in range(3):
                    run()
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()    # the launches without the
                with torch.cuda.graph(graph):     # host's time between them
                    gstream = torch.cuda.current_stream().cuda_stream
                    g_scratch, g_barrier = k.scratch(b, n, l, 1, x.device,
                                                     gstream)
                    for _ in range(args.iters):
                        err = k.fwd(x.data_ptr(), mask.data_ptr(),
                                    gates.data_ptr(), None, bv.data_ptr(),
                                    bu.data_ptr(), ww.data_ptr(),
                                    bw.data_ptr(), pooled.data_ptr(),
                                    attn.data_ptr(), g_scratch.data_ptr(),
                                    g_barrier.data_ptr(), b, n, l,
                                    GATE_WIDTH, 1, gstream)
                        if err:
                            raise RuntimeError(f"{name}: CUDA error {err}")
                graph.replay()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                for _ in range(3):
                    graph.replay()
                end.record()
                torch.cuda.synchronize()
                times[name] = start.elapsed_time(end) / (3 * args.iters)
                del graph
            out["shapes"][f"{b}x{n}x{l}"] = {
                "valid_rows": int(mask.sum()), "ms": times,
                "plan_rows_blocks": plans}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = {"card": card, **out}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
