"""Micro-batching HTTP server (counterpart of `instancediffusion_tpu/serve.py`).

Requests are gathered into micro-batches of a fixed `batch_size` and run as
one `generate_batch` call each: a collector thread waits for the first
request, then up to `max_wait_ms` for more (or until `batch_size` are
waiting), pads a short batch by repeating its last meta and seed (the
padding rows are dropped before replying) and resolves each request's
future. A fixed batch keeps every call at the one shape the warm-up ran.
Each request's `seed` (default 0) fixes its image.

Endpoints (stdlib http.server):
  GET  /healthz    -> {"ok": true, "device": ..., "requests": N, "batches": N,
                   "batch_size": N, "batch_s": {"p50", "p90"},
                   "queue_wait_s": {"p50", "p90"}} (None before a batch)
  POST /generate   body: a demo meta as JSON (prompt, phrases, locations[,
                   points, scribbles, polygons, segs], optional seed)
                   -> image/png (?format=json: base64 PNG and latency)

The PNG is encoded with zlib and struct (no imaging library needed).

With `--mesh` the server spans the ranks of a process group (torchrun, or
the launcher's --coordinator / --num_processes / --process_id on each
rank): rank 0 runs the HTTP server and the batching queue, each batch's
(metas, seeds) reaches the other ranks by `broadcast_object_list`, and
every rank runs `generate_batch(mesh=)` on its rows (`MeshLeader`,
`follow`); a None broadcast ends the followers.

    python -m instancediffusion_tpu_torch.serve --steps 20 --sampler dpm \\
        --batch_size 8 --port 8321 [--ckpt pretrained/instancediffusion_sd15.pth]

`--aot_dir DIR` turns on the program cache (`aot.py`): the warm-up batch
captures the serving program as a CUDA graph, every later batch replays
it, and the kernel library is kept in DIR for the next start.

`--ckpt` loads a reference / SD1.5 checkpoint (`from_checkpoint`); without
it, or when the file is missing (a warning), the weights are random
(seeded). The hash tokenizer stands in for CLIP's BPE files where they are
missing (IDTPU_ALLOW_HASH_TOKENIZER=1).
"""

from __future__ import annotations

import base64
import collections
import json
import os
import queue
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from instancediffusion_tpu_torch.config import Config, apply_test_preset
from instancediffusion_tpu_torch.io.png import png_bytes


class BatchingQueue:
    """Collects generate requests into fixed-size micro-batches.

    submit() returns a Future resolving to one (H, W, 3) uint8 array. The
    worker drains up to `batch_size` requests, waiting at most
    `max_wait_ms` after the first arrival before running a short (padded)
    batch. `batch_seconds` holds the host seconds of the latest batches,
    `queue_wait_seconds` those of the latest requests from `submit` to the
    start of their batch."""

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
        self.queue_wait_seconds: collections.deque = collections.deque(maxlen=256)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, meta: dict, seed: int = 0) -> Future:
        fut: Future = Future()
        self._q.put((meta, int(seed), fut, time.perf_counter()))
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
            metas = [m for m, _, _, _ in items]
            seeds = [s for _, s, _, _ in items]
            metas += [metas[-1]] * (self.batch_size - n)
            seeds += [seeds[-1]] * (self.batch_size - n)
            start = time.perf_counter()
            self.queue_wait_seconds.extend(start - t for _, _, _, t in items)
            try:
                imgs = self._generate_batch(metas, seeds=seeds, **self.gen_kwargs)[:n]
                self.batch_seconds.append(time.perf_counter() - start)
                self.batches += 1
                self.requests += n
                for (_, _, fut, _), img in zip(items, imgs):
                    fut.set_result(np.asarray(img))
            except Exception as e:  # resolve every future, never wedge
                for _, _, fut, _ in items:
                    if not fut.done():
                        fut.set_exception(e)

    def health(self) -> dict:
        """What /healthz reports of the queue: requests and batches served,
        and the median and p90 of the latest batches' seconds and of the
        latest requests' queue wait (None before the first batch)."""
        out = {"requests": self.requests, "batches": self.batches,
               "batch_size": self.batch_size}
        for name, seconds in (("batch_s", self.batch_seconds),
                              ("queue_wait_s", self.queue_wait_seconds)):
            v = list(seconds)
            out[name] = (dict(zip(("p50", "p90"), map(float, np.percentile(v, [50, 90]))))
                         if v else None)
        return out


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
                self._json(200, {"ok": True, "device": device_desc, **batcher.health()})
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


class MeshLeader:
    """Rank 0's `generate_batch` over a mesh: broadcasts each batch's
    (metas, seeds, options) to the other ranks, which run `follow`, then
    takes its own part. A lock keeps the broadcasts in one order; `close`
    waits for a batch in flight, then ends the followers."""

    def __init__(self, pipe, mesh):
        self.pipe, self.mesh = pipe, mesh
        self._lock = threading.Lock()
        self._closed = False

    def __call__(self, metas, seeds, **kw):
        import torch.distributed as dist

        with self._lock:
            if self._closed:
                raise RuntimeError("the mesh server is closed")
            dist.broadcast_object_list([(list(metas), list(seeds), kw)], src=0)
            return self.pipe.generate_batch(metas, seeds=seeds, mesh=self.mesh, **kw)

    def close(self):
        import torch.distributed as dist

        with self._lock:
            if not self._closed:
                self._closed = True
                dist.broadcast_object_list([None], src=0)


def follow(pipe, mesh) -> int:
    """A rank other than 0 of a mesh server: run every batch rank 0
    broadcasts until the None that ends the server. Returns the batch
    count."""
    import torch.distributed as dist

    n = 0
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0)
        if msg[0] is None:
            return n
        metas, seeds, kw = msg[0]
        pipe.generate_batch(metas, seeds=seeds, mesh=mesh, **kw)
        n += 1


WARM_META = {"prompt": "warmup", "phrases": ["a thing"], "locations": [[0.2, 0.2, 0.8, 0.8]],
             "points": [[0.5, 0.5]]}


def serve(pipe, host: str = "127.0.0.1", port: int = 8321, batch_size: int = 8,
          max_wait_ms: float = 50.0, warmup: bool = True, mesh=None,
          aot_dir: str | None = None, **gen_kwargs) -> ThreadingHTTPServer:
    """Start serving `pipe` (InstanceDiffusionPipeline) on a background
    thread; port 0 takes a free one (`server.server_address[1]`). With
    `warmup`, one full batch runs before the port opens. Returns the
    running server: stop it with .shutdown(), .server_close() and
    .batcher.close(). With a `mesh` this is rank 0 of it (the other ranks
    run `follow`), and .leader.close() then ends them (.leader is None
    without a mesh).

    aot_dir: opt into the program cache (`pipe.enable_aot`) before the
    warm-up, so the warm-up batch captures the serving variant as a CUDA
    graph and every later batch replays it; the kernel library is kept in
    that directory for the next start."""
    if aot_dir:
        pipe.enable_aot(aot_dir)
    leader = None if mesh is None else MeshLeader(pipe, mesh)
    generate = pipe.generate_batch if leader is None else leader
    batcher = BatchingQueue(generate, batch_size=batch_size,
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
    server.batcher, server.leader = batcher, leader
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"serve: listening on http://{host}:{server.server_address[1]}", flush=True)
    return server


def build_pipeline(ckpt: str | None, test_config: str = "box", seed: int = 0,
                   device="cuda"):
    """The served pipeline: the checkpoint's weights when `ckpt` names a
    file; otherwise seeded random ones (with a warning when `ckpt` was given
    but is missing). bf16 on the card, float32 on the CPU."""
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline, default_dtype

    cfg = apply_test_preset(Config(), test_config)
    dtype = default_dtype(device)
    if ckpt and os.path.exists(ckpt):
        return InstanceDiffusionPipeline.from_checkpoint(ckpt, cfg, device=device, dtype=dtype)
    if ckpt:
        print(f"warning: checkpoint {ckpt} not found; random init", flush=True)
    return InstanceDiffusionPipeline.random_init(cfg, seed=seed, device=device, dtype=dtype)


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
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights (without --ckpt)")
    p.add_argument("--device", type=str, default=None,
                   help="default cuda (cuda:LOCAL_RANK with --mesh)")
    p.add_argument("--mesh", action="store_true",
                   help="shard serving batches over the ranks (torchrun or the flags below)")
    p.add_argument("--aot_dir", type=str, default=None,
                   help="program cache directory: the serving batch replays a CUDA graph "
                        "and the kernel library is kept there across restarts")
    from instancediffusion_tpu_torch.launch import add_dist_args, join

    add_dist_args(p)
    args = p.parse_args(argv)
    mesh, device = None, args.device or "cuda"
    if args.mesh:
        from instancediffusion_tpu_torch.parallel.mesh import make_mesh

        args.multihost = True  # torchrun's environment unless --coordinator is given
        device, rank, _ = join(args)
        mesh = make_mesh()
    pipe = build_pipeline(args.ckpt, args.test_config, args.seed, device)
    gen = dict(steps=args.steps, guidance_scale=args.guidance_scale, alpha=args.alpha,
               mis=args.mis, sampler=args.sampler)
    if mesh is not None and rank != 0:
        follow(pipe, mesh)
        return
    server = serve(pipe, host=args.host, port=args.port, batch_size=args.batch_size,
                   max_wait_ms=args.max_wait_ms, mesh=mesh, aot_dir=args.aot_dir, **gen)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.shutdown()
        server.server_close()
        server.batcher.close()
        if server.leader is not None:
            server.leader.close()


if __name__ == "__main__":
    main()
