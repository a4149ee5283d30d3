"""Micro-batching HTTP server (counterpart of `instancediffusion_tpu/serve.py`).

Requests are gathered into micro-batches of a fixed `batch_size` and run as
one `generate_batch` call each: a collector thread waits for the first
request, then up to `max_wait_ms` for more (or until `batch_size` are
waiting), pads a short batch by repeating its last meta and seed (the
padding rows are dropped before replying) and resolves each request's
future. A fixed batch keeps every call at the one shape the warm-up ran.
Each request's `seed` (default 0) fixes its image.

Endpoints (stdlib http.server):
  GET  /healthz    -> {"ok": true, "device": ..., "requests": N, ...}
  POST /generate   body: a demo meta as JSON (prompt, phrases, locations[,
                   points, scribbles, polygons, segs], optional seed)
                   -> image/png (?format=json: base64 PNG and latency)

The PNG is encoded with zlib and struct (no imaging library needed).

    python -m instancediffusion_tpu_torch.serve --steps 20 --sampler dpm \\
        --batch_size 8 --port 8321

There is no checkpoint loader yet: `--ckpt` raises, and without it the
weights are random (seeded), with the hash tokenizer standing in for CLIP's
BPE files where they are missing (IDTPU_ALLOW_HASH_TOKENIZER=1).
"""

from __future__ import annotations

import base64
import collections
import json
import queue
import struct
import threading
import time
import zlib
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


class BatchingQueue:
    """Collects generate requests into fixed-size micro-batches.

    submit() returns a Future resolving to one (H, W, 3) uint8 array. The
    worker drains up to `batch_size` requests, waiting at most
    `max_wait_ms` after the first arrival before running a short (padded)
    batch. `batch_seconds` holds the host seconds of the latest batches."""

    def __init__(self, generate_batch, batch_size: int = 8, max_wait_ms: float = 50.0,
                 **gen_kwargs):
        self._generate_batch = generate_batch
        self.batch_size = int(batch_size)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self.gen_kwargs = gen_kwargs
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.batches = 0
        self.requests = 0
        self.batch_seconds: collections.deque = collections.deque(maxlen=256)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, meta: dict, seed: int = 0) -> Future:
        fut: Future = Future()
        self._q.put((meta, int(seed), fut))
        return fut

    def close(self, timeout: float = 5.0):
        self._stop.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout)

    def _drain(self):
        """Block for the first request, then gather up to batch_size for at
        most max_wait_s."""
        first = self._q.get()
        if first is None:
            return []
        items = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(items) < self.batch_size:
            budget = deadline - time.monotonic()
            if budget <= 0:
                break
            try:
                nxt = self._q.get(timeout=budget)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _run(self):
        while not self._stop.is_set():
            items = self._drain()
            if not items:
                continue
            n = len(items)
            metas = [m for m, _, _ in items]
            seeds = [s for _, s, _ in items]
            metas += [metas[-1]] * (self.batch_size - n)
            seeds += [seeds[-1]] * (self.batch_size - n)
            t0 = time.perf_counter()
            try:
                imgs = self._generate_batch(metas, seeds=seeds, **self.gen_kwargs)[:n]
                self.batch_seconds.append(time.perf_counter() - t0)
                self.batches += 1
                self.requests += n
                for (_, _, fut), img in zip(items, imgs):
                    fut.set_result(np.asarray(img))
            except Exception as e:  # resolve every future, never wedge
                for _, _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)


def png_bytes(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes: 8-bit RGB, no interlace, filter 0 on
    every row, one zlib stream."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"png_bytes takes (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def make_handler(batcher: BatchingQueue, device_desc: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj: dict):
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"ok": True, "device": device_desc,
                                 "requests": batcher.requests, "batches": batcher.batches,
                                 "batch_size": batcher.batch_size})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/generate"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                meta = json.loads(self.rfile.read(n) or b"{}")
                seed = int(meta.pop("seed", 0))
                if "prompt" not in meta:
                    raise ValueError("meta needs at least a 'prompt'")
                meta.setdefault("phrases", [])
                meta.setdefault("locations", [])
            except Exception as e:
                self._json(400, {"error": str(e)})
                return
            t0 = time.monotonic()
            try:
                img = batcher.submit(meta, seed).result(timeout=600)
            except Exception as e:
                self._json(500, {"error": str(e)})
                return
            dt = time.monotonic() - t0
            png = png_bytes(img)
            if "format=json" in (self.path.split("?", 1) + [""])[1]:
                self._json(200, {"png_base64": base64.b64encode(png).decode(),
                                 "latency_s": round(dt, 3), "shape": list(img.shape)})
            else:
                self._reply(200, png, "image/png")

    return Handler


WARM_META = {"prompt": "warmup", "phrases": ["a thing"], "locations": [[0.2, 0.2, 0.8, 0.8]],
             "points": [[0.5, 0.5]]}


def serve(pipe, host: str = "127.0.0.1", port: int = 8321, batch_size: int = 8,
          max_wait_ms: float = 50.0, warmup: bool = True,
          **gen_kwargs) -> ThreadingHTTPServer:
    """Start serving `pipe` (InstanceDiffusionPipeline) on a background
    thread; port 0 takes a free one (`server.server_address[1]`). With
    `warmup`, one full batch runs before the port opens. Returns the
    running server: stop it with .shutdown(), .server_close() and
    .batcher.close()."""
    batcher = BatchingQueue(pipe.generate_batch, batch_size=batch_size,
                            max_wait_ms=max_wait_ms, **gen_kwargs)
    if warmup:
        t0 = time.time()
        futs = [batcher.submit(WARM_META, seed=i) for i in range(batch_size)]
        for f in futs:
            f.result(timeout=3600)
        print(f"serve: warm-up ran in {time.time() - t0:.1f}s", flush=True)
    import torch

    dev = pipe.device
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    server = ThreadingHTTPServer((host, port), make_handler(batcher, device))
    server.batcher = batcher
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"serve: listening on http://{host}:{server.server_address[1]}", flush=True)
    return server


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("InstanceDiffusion serving (PyTorch port)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--test_config", type=str, default="box")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=50.0)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--alpha", type=float, default=0.75)
    p.add_argument("--mis", type=float, default=0.0)
    p.add_argument("--sampler", type=str, default="plms", choices=["plms", "dpm", "ddim"])
    p.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if args.ckpt:
        raise NotImplementedError("--ckpt: the port has no checkpoint loader yet; run "
                                  "without it for seeded random weights")

    from instancediffusion_tpu_torch.config import Config, apply_test_preset
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    cfg = apply_test_preset(Config(), args.test_config)
    pipe = InstanceDiffusionPipeline.random_init(cfg, seed=args.seed, device=args.device)
    server = serve(pipe, host=args.host, port=args.port, batch_size=args.batch_size,
                   max_wait_ms=args.max_wait_ms, steps=args.steps,
                   guidance_scale=args.guidance_scale, alpha=args.alpha, mis=args.mis,
                   sampler=args.sampler)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
        server.server_close()
        server.batcher.close()


if __name__ == "__main__":
    main()
