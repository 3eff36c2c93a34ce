"""HTTP front end for the ChainEngine (stdlib only).

Counterpart of ``fgdm_tpu/server.py``, with the same endpoints, JSON fields,
error codes and Prometheus names:

POST /generate  {"prompts": ["..."], "seed": 0}
                or {"prompts": [...], "seeds": [s0, s1, ...]} (per prompt)
  -> {"images": [...b64 PNG...], "conditions": [...b64 PNG...],
      "latency_s": float}
GET /healthz
  -> {"status": "ok", "max_batch": N, "compile_seconds": float,
      "batch_window_ms": W}
GET /metrics
  -> Prometheus text: requests/errors/images totals, latency sum, engine
     batches run (batch occupancy = images_total / batches_total)

``batch_window_ms > 0`` coalesces concurrent requests, whatever their seeds,
into one engine batch until it is full or the window has passed since the
first arrival; the engine's per-slot seeds make a coalesced request equal to
the same request run solo.  PNGs are written with ``zlib`` and ``struct``.

``main`` (``python -m fgdm_tpu_torch.server``) serves the engine that
``build_engine`` assembles: from the reference checkpoints ``--ckpt`` /
``--cn_ckpt`` (``checkpoint/loader.py``), else from seeded random weights.
"""

from __future__ import annotations

import base64
import json
import struct
import threading
import time
import zlib
from http.server import (BaseHTTPRequestHandler, HTTPServer,
                         ThreadingHTTPServer)
from typing import Optional

import numpy as np

__all__ = ["png_bytes", "RequestBatcher", "ServerMetrics", "make_handler",
           "serve", "build_engine", "main"]

def png_bytes(arr: np.ndarray) -> bytes:
    """An 8-bit RGB PNG (IHDR, one IDAT, IEND; filter 0 on every row) of a
    uint8 ``[H, W, 3]`` array."""
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"png_bytes takes uint8 [H, W, 3], got {arr.dtype} "
                         f"{arr.shape}")
    h, w, _ = arr.shape
    rows = np.zeros((h, 1 + 3 * w), np.uint8)
    rows[:, 1:] = arr.reshape(h, 3 * w)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)   # 8-bit RGB
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def _png_b64(arr: np.ndarray) -> str:
    return base64.b64encode(png_bytes(arr)).decode("ascii")


class _Pending:
    __slots__ = ("prompts", "seeds", "event", "result", "error")

    def __init__(self, prompts, seeds):
        self.prompts = list(prompts)
        self.seeds = list(seeds)
        self.event = threading.Event()
        self.result = None
        self.error = None


class RequestBatcher:
    """Coalesces concurrent ``generate()`` calls into full engine batches.

    A dispatcher thread takes the oldest pending request, then absorbs
    requests (FIFO, skipping ones that do not fit) until the batch is full
    or ``window_ms`` has passed since dispatch started; the group runs as
    ONE ``engine.generate`` call and each caller gets its slice.
    ``window_ms=0`` is a serializing passthrough.  ``close()`` stops the
    dispatcher once the queue is empty (``serve`` calls it when it stops),
    so the thread no longer holds the engine."""

    def __init__(self, engine, window_ms: float = 0.0):
        self.engine = engine
        self.window_ms = window_ms
        self._window = max(window_ms, 0.0) / 1000.0
        self._cv = threading.Condition()
        self._q: list = []
        self._closed = False
        self.batches_run = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="fgdm-request-batcher")
        self._thread.start()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join()

    # the handler-facing surface mirrors ChainEngine
    @property
    def max_batch(self):
        return self.engine.max_batch

    @property
    def compile_seconds(self):
        return self.engine.compile_seconds

    def generate(self, prompts, seed: int = 0, seeds=None):
        req = _Pending(prompts,
                       seeds if seeds is not None else [seed] * len(prompts))
        with self._cv:
            self._q.append(req)
            self._cv.notify_all()
        req.event.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def _take_group(self):
        group = [self._q.pop(0)]
        slots = len(group[0].prompts)
        deadline = time.monotonic() + self._window
        while slots < self.engine.max_batch:
            for i, r in enumerate(self._q):
                if slots + len(r.prompts) <= self.engine.max_batch:
                    group.append(self._q.pop(i))
                    slots += len(group[-1].prompts)
                    break
            else:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
        return group

    def _loop(self):
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q:
                    return
                group = self._take_group()
            prompts = [p for r in group for p in r.prompts]
            seeds = [s for r in group for s in r.seeds]
            try:
                out = self.engine.generate(prompts, seeds=seeds)
            except Exception as e:  # deliver the failure to every caller
                for r in group:
                    r.error = e
                    r.event.set()
                continue
            self.batches_run += 1
            ofs = 0
            for r in group:
                n = len(r.prompts)
                r.result = {k: v[ofs:ofs + n] for k, v in out.items()}
                ofs += n
                r.event.set()


class ServerMetrics:
    """Thread-safe serving counters, exposed in Prometheus text format."""

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.errors_total = 0
        self.images_total = 0
        self.latency_seconds_sum = 0.0

    def observe(self, n_images: int, latency_s: float, error: bool):
        with self._lock:
            self.requests_total += 1
            if error:
                self.errors_total += 1
            else:
                self.images_total += n_images
                self.latency_seconds_sum += latency_s

    def render(self, engine) -> str:
        with self._lock:
            lines = [
                "# TYPE fgdm_requests_total counter",
                f"fgdm_requests_total {self.requests_total}",
                "# TYPE fgdm_errors_total counter",
                f"fgdm_errors_total {self.errors_total}",
                "# TYPE fgdm_images_total counter",
                f"fgdm_images_total {self.images_total}",
                "# TYPE fgdm_request_latency_seconds_sum counter",
                f"fgdm_request_latency_seconds_sum "
                f"{self.latency_seconds_sum:.6f}",
                "# TYPE fgdm_max_batch gauge",
                f"fgdm_max_batch {engine.max_batch}",
            ]
            batches = getattr(engine, "batches_run", None)
            if batches is not None:
                lines += ["# TYPE fgdm_engine_batches_total counter",
                          f"fgdm_engine_batches_total {batches}"]
            if engine.compile_seconds is not None:
                lines += ["# TYPE fgdm_compile_seconds gauge",
                          f"fgdm_compile_seconds "
                          f"{engine.compile_seconds:.3f}"]
        return "\n".join(lines) + "\n"


def make_handler(engine, metrics: Optional[ServerMetrics] = None):
    metrics = metrics or ServerMetrics()

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {
                    "status": "ok",
                    "max_batch": engine.max_batch,
                    "compile_seconds": engine.compile_seconds,
                    "batch_window_ms": getattr(engine, "window_ms", 0),
                })
            elif self.path == "/metrics":
                body = metrics.render(engine).encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(length) or b"{}")
                except json.JSONDecodeError as e:
                    self._send(400, {"error": f"invalid JSON body: {e}"})
                    return
                prompts = req.get("prompts")
                if not isinstance(prompts, list) or not prompts or \
                        not all(isinstance(p, str) for p in prompts):
                    self._send(400, {"error": "prompts must be a non-empty "
                                              "list of strings"})
                    return
                if len(prompts) > engine.max_batch:
                    self._send(400, {
                        "error": f"at most {engine.max_batch} prompts "
                                 f"per request"})
                    return
                seed = int(req.get("seed", 0))
                seeds = req.get("seeds")
                if seeds is not None and (
                        not isinstance(seeds, list)
                        or len(seeds) != len(prompts)
                        or not all(isinstance(s, int) for s in seeds)):
                    self._send(400, {"error": "seeds must be a list of "
                                              "ints, one per prompt"})
                    return
                t0 = time.perf_counter()
                out = engine.generate(prompts, seed=seed, seeds=seeds)
                latency = time.perf_counter() - t0
                metrics.observe(len(prompts), latency, error=False)
                self._send(200, {
                    "images": [_png_b64(a) for a in out["images"]],
                    "conditions": [_png_b64(a) for a in out["conditions"]],
                    "latency_s": round(latency, 3),
                })
            except Exception as e:  # surface errors as JSON, keep serving
                metrics.observe(0, 0.0, error=True)
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *args):  # quiet default logging
            pass

    return Handler


def serve(engine, host: str = "127.0.0.1", port: int = 8500,
          max_requests: Optional[int] = None,
          batch_window_ms: float = 0.0,
          ready: Optional[threading.Event] = None) -> HTTPServer:
    """Blocking serve loop (``max_requests`` for tests and smoke runs).

    ``batch_window_ms > 0``: requests are handled concurrently
    (``ThreadingHTTPServer``) and coalesced by a ``RequestBatcher``, closed
    when the loop ends.  Port 0
    binds a free port; ``ready``, if given, is set once the socket listens,
    with the server as its ``server`` attribute (``server_address`` holds
    the port)."""
    batcher = None
    if batch_window_ms > 0:
        batcher = RequestBatcher(engine, batch_window_ms)
        httpd = ThreadingHTTPServer((host, port), make_handler(batcher))
        httpd.daemon_threads = True
    else:
        httpd = HTTPServer((host, port), make_handler(engine))
    if ready is not None:
        ready.server = httpd
        ready.set()
    try:
        if max_requests is None:
            httpd.serve_forever()
        else:
            for _ in range(max_requests):
                httpd.handle_request()
    finally:
        httpd.server_close()
        if batcher is not None:
            batcher.close()
    return httpd


def build_engine(ckpt: Optional[str] = None, cn_ckpt: Optional[str] = None,
                 device="cuda", **engine_kwargs):
    """The ``ChainEngine`` that ``main`` serves (JAX ``server.py:320-337``).

    With ``ckpt`` and/or ``cn_ckpt`` the two pipelines load through
    ``checkpoint/loader.py`` (``load_fgdm``, ``load_controlnet``; a pipeline
    without a file takes the seeded init) and the tokenizer must have the
    real CLIP vocabulary, or ``FGDM_ALLOW_HASH_TOKENIZER=1``
    (``check_production``).  With neither, the models are
    ``builders.build_chain``'s seeded random weights.  ``engine_kwargs`` go
    to ``ChainEngine``."""
    from fgdm_tpu_torch.models.clip import CLIPTokenizer
    from fgdm_tpu_torch.serving import ChainEngine

    tok = CLIPTokenizer()
    if ckpt is None and cn_ckpt is None:
        from fgdm_tpu_torch.builders import build_chain

        ld, cldm = build_chain(device=device)
    else:
        from fgdm_tpu_torch.checkpoint.loader import (load_controlnet,
                                                      load_fgdm)

        # real weights with the hash-fallback tokenizer degrade the output
        # quietly, so refuse them (models/clip.py check_production)
        tok.check_production("server")
        ld = load_fgdm(ckpt, device=device)
        cldm = load_controlnet(cn_ckpt, device=device)
    return ChainEngine(ld, cldm, tokenizer=tok, **engine_kwargs)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="FG-DM chain HTTP server "
                                            "(PyTorch, one CUDA device)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="factor-1 checkpoint (fgdm_seg.pth)")
    p.add_argument("--cn_ckpt", type=str, default=None,
                   help="ControlNet stage checkpoint "
                        "(fgdm_control_sd15_seg.pth)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--max_batch", type=int, default=4)
    p.add_argument("--staged", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="kept for parity with the JAX server, where it "
                        "splits the compile into four stages; eager PyTorch "
                        "runs the same calls either way")
    p.add_argument("--batch_window_ms", type=float, default=0.0,
                   help="coalesce concurrent requests (any seeds: per-slot "
                        "seeds keep results equal to solo runs) into full "
                        "engine batches, waiting up to this long after the "
                        "first arrival (0 = off)")
    p.add_argument("--f1_steps", type=int, default=50)
    p.add_argument("--f1_sampler", type=str, default="ddim",
                   choices=("ddim", "plms", "dpm"),
                   help="condition-factor sampler; --f1_sampler dpm "
                        "--f1_steps 20 is the fast preset")
    opt = p.parse_args(argv)

    # the conv-kernel flags come from FGDM_PALLAS_CONV / FGDM_PALLAS_CONV_VAE
    engine = build_engine(opt.ckpt, opt.cn_ckpt, device="cuda",
                          max_batch=opt.max_batch, staged=opt.staged,
                          f1_steps=opt.f1_steps, f1_sampler=opt.f1_sampler)
    print(f"[server] ready on {opt.host}:{opt.port} "
          f"(warmup {engine.compile_seconds:.1f}s)", flush=True)
    serve(engine, opt.host, opt.port, batch_window_ms=opt.batch_window_ms)


if __name__ == "__main__":
    main()
