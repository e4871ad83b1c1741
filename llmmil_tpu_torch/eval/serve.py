"""Local HTTP inference daemon over a serving artifact.

A long-lived service around the artifact of :mod:`.export` — load once,
warm up every exported signature, then answer prediction requests until
stopped.

Protocol (stdlib only):

- ``GET /healthz``    → ``{"status": "ok", "signatures": [...],
  "requests": n, "errors": n}``
- ``GET /signatures`` → the manifest's per-entry ``{name: [shape,
  dtype]}`` map (what a client must send).
- ``POST /predict``   → body is an ``.npz`` archive (``np.savez`` of the
  batch arrays, same names/shapes/dtypes as an exported signature);
  response ``{"probs": [[...]], "device_ms": t}``.  ``device_ms`` is taken
  after the result has reached the host, so it includes the device work.
  An unknown signature is a 400 whose ``error`` lists the available
  signatures (mirrors ``ServingModel.call``'s KeyError).

One card serves one inference at a time — a lock serializes model calls;
the threading server still overlaps request parsing and response IO with
device compute.  Clients pick a signature (batch × bag bucket) that was
exported, exactly like the bucketed bag padding of ``data/bags.py``.

CLI: ``python -m llmmil_tpu_torch.eval.serve --artifact model.llmmil``.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict

import numpy as np

from .export import ServingModel, load_artifact

__all__ = ["InferenceServer", "serve_artifact", "warmup_batches"]


def warmup_batches(model: ServingModel):
    """Zero-filled batch per exported signature, rebuilt from the
    manifest's recorded shapes/dtypes — the first call at a shape pays for
    kernel builds, library handles and allocator growth, so every entry is
    run once before the first real request."""
    for key, sig in model.signatures.items():
        yield key, {name: np.zeros(shape, dtype)
                    for name, (shape, dtype) in sig.items()}


class InferenceServer:
    """``ThreadingHTTPServer`` around a loaded :class:`ServingModel`.

    ``start()`` binds (port 0 → ephemeral, read ``.port``), warms up, and
    serves on a daemon thread; ``stop()`` shuts down cleanly.  Use as a
    context manager in tests.
    """

    def __init__(self, model: ServingModel, host: str = "127.0.0.1",
                 port: int = 0, warmup: bool = True):
        self.model = model
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.stats = {"requests": 0, "errors": 0}
        self._warmup = warmup
        # Largest request a signature can legitimately need: npz of the
        # biggest entry's arrays (compressed archives are smaller). 4x
        # covers archive framing; anything beyond is a hostile/broken
        # client that would otherwise let one request exhaust host RAM.
        sig_bytes = max(
            (sum(int(np.prod(shape)) * np.dtype(dtype).itemsize
                 for shape, dtype in sig.values())
             for sig in model.signatures.values()), default=0)
        self._max_body = max(1 << 20, 4 * sig_bytes)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):            # quiet access log
                pass

            def _json(self, code: int, payload: Dict[str, Any]):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {"status": "ok",
                                     "signatures":
                                         sorted(outer.model.signatures),
                                     **outer.stats})
                elif self.path == "/signatures":
                    self._json(200, outer.model.signatures)
                else:
                    self._json(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                if self.path != "/predict":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                with outer._stats_lock:
                    outer.stats["requests"] += 1
                try:
                    n = int(self.headers.get("Content-Length", "0"))
                    if n > outer._max_body:
                        self._json(413, {
                            "error": f"body {n} bytes exceeds the largest "
                                     f"exported signature "
                                     f"({outer._max_body} byte cap)"})
                        return
                    with np.load(io.BytesIO(self.rfile.read(n)),
                                 allow_pickle=False) as arrs:
                        batch = {k: arrs[k] for k in arrs.files}
                    t0 = time.perf_counter()
                    with outer._lock:
                        probs = outer.model.call(batch)
                    ms = (time.perf_counter() - t0) * 1e3
                    if not np.isfinite(probs).all():
                        raise ValueError(
                            "non-finite probs (check input ranges / "
                            "token ids)")
                    self._json(200, {"probs": probs.tolist(),
                                     "device_ms": round(ms, 3)})
                except (KeyError, ValueError) as e:   # client-fixable
                    with outer._stats_lock:
                        outer.stats["errors"] += 1
                    self._json(400, {"error": str(e)})
                except Exception as e:                # noqa: BLE001
                    with outer._stats_lock:
                        outer.stats["errors"] += 1
                    self._json(500, {"error": f"{type(e).__name__}: {e}"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "InferenceServer":
        if self._warmup:
            with self._lock:
                for _key, b in warmup_batches(self.model):
                    self.model.call(b)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def serve_artifact(path: str, host: str = "127.0.0.1", port: int = 8000,
                   warmup: bool = True, device=None) -> InferenceServer:
    """Load an artifact file and return a started :class:`InferenceServer`
    (on the CUDA card unless ``device`` names another)."""
    return InferenceServer(load_artifact(path, device=device), host=host,
                           port=port, warmup=warmup).start()


def main(argv=None) -> None:
    """Serve an exported artifact over local HTTP until stopped."""
    import argparse
    import signal

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--artifact", required=True,
                   help="artifact file from llmmil_tpu_torch.eval.export")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default=None,
                   help="default cuda; pass cpu to serve without a card")
    p.add_argument("--no_warmup", action="store_true",
                   help="skip running every signature once at startup "
                        "(first request per signature then pays it)")
    args = p.parse_args(argv)

    srv = serve_artifact(args.artifact, host=args.host, port=args.port,
                         warmup=not args.no_warmup, device=args.device)
    sigs = "\n  ".join(sorted(srv.model.signatures))
    print(f"serving {args.artifact} on http://{args.host}:{srv.port} "
          f"({srv.model.device})\nsignatures:\n  {sigs}", flush=True)

    # POSIX requires the waited-for signals to be blocked before sigwait —
    # otherwise CPython's default SIGINT handler races the C sigwait loop
    # and SIGTERM keeps its terminate-now disposition, skipping srv.stop().
    signal.pthread_sigmask(signal.SIG_BLOCK,
                           {signal.SIGINT, signal.SIGTERM})
    stop = signal.sigwait([signal.SIGINT, signal.SIGTERM])
    print(f"signal {stop}: shutting down", flush=True)
    srv.stop()


if __name__ == "__main__":
    main()
