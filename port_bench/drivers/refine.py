"""Driver of `SDXLRefinerPipeline.refine` traffic: the cascade's second
stage (`inference.py --cascade_strength`), requests of `num_images`
seeded stage-1 images with one seeded prompt, run back to back.

Traffic keys: num_images, image_size (the stage-1 images' side),
strength, steps, guidance_scale, aesthetic_score, negative_aesthetic_score,
negative_prompt, planned_requests (requests drawn before the window),
trace_requests (the requests a traced run records), check_images (images
of one request drawn from the seed that the reference recomputes),
limit_mean_abs_u8 (the check's limit).

A request is what the CLI's cascade does with a batch of images: the uint8
images as float32 / 255, one `refine` (blocking: the images come back on
the host), the result as uint8 by `(out * 255).astype(uint8)`.

End-to-end: img_s, images of whole requests / (last completion - window
start), no request started after the window's length; setup_s.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from port_bench.drivers.generate import AttentionProbe, mean_abs
from port_bench.harness import flops, layouts, models, refiner, refiner_flops, trace
from port_bench.harness.context import Check, Outcome, Run
from port_bench.harness.layouts import strata
from port_bench.harness.stats import rate


def options(t: dict) -> dict:
    """The traffic's `refine` keyword arguments."""
    keys = ("negative_prompt", "strength", "steps", "guidance_scale", "aesthetic_score",
            "negative_aesthetic_score")
    return {k: t[k] for k in keys}


def to_u8(images: np.ndarray) -> np.ndarray:
    """Refined float images in [0, 1] as the CLI writes them."""
    return (images * 255).astype(np.uint8)


def run(ctx: Run) -> Outcome:
    t = ctx.traffic
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    dtype = torch.bfloat16 if cuda else torch.float32
    w = refiner.weights(ctx.config, ctx.seed, dev, dtype)
    pipe = refiner.port(ctx.config, w, dtype)
    del w  # the program holds its own copies; the reference draws them again
    kw = options(t)

    def refine(req: refiner.Request) -> np.ndarray:
        images = np.asarray(req.images, np.float32) / 255.0
        return to_u8(pipe.refine(images, req.prompt, noise=req.noise, **kw))

    refine(refiner.request(ctx.seed, 10**6, t, dev))
    plan = [refiner.request(ctx.seed, i, t, dev) for i in range(t.get("planned_requests", 0))]

    from instancediffusion_tpu_torch import kernels

    if ctx.trace:
        trace.prime()
    attn = AttentionProbe() if ctx.trace else None
    ff = FFProbe() if ctx.trace else None
    n_trace = t.get("trace_requests", 1)
    window = trace.Window(ctx.trace)
    done, spent = [], []
    kernels.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    start = ctx.start_window()
    with window, (attn or contextlib.nullcontext()), (ff or contextlib.nullcontext()):
        i = 0
        while i < n_trace if ctx.trace else (i == 0 or time.perf_counter() - start < ctx.seconds):
            t0 = time.perf_counter()
            out = refine(plan[i] if i < len(plan) else refiner.request(ctx.seed, i, t, dev))
            done.append((time.perf_counter(), i, out))
            spent.append((done[-1][0] - t0, pipe.last_timings["text_encode"],
                          pipe.last_timings["sample"]))
            i += 1
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    images = len(done) * t["num_images"]
    e2e = {"img_s": rate(images, start, done[-1][0])}
    # a request's seconds, and of them the refine's text encode and its
    # program (noise draw to images on the host); the rest is this module's
    # conversions and the refine's schedule
    for k, name in enumerate(("request seconds", "text_encode", "sample")):
        print(f"refine: {name}", [round(r[k], 4) for r in spent], file=sys.stderr)
    print(f"refine: {len(done)} requests; feed-forward calls {kernels.LAUNCHES['fused_ff_geglu']} "
          f"fused, {kernels.ROUTES['ff_geglu_unfused']} unfused (ROUTES['ff_geglu_unfused'])",
          file=sys.stderr)

    readings = {"requests": len(done)}
    if ctx.trace:
        readings.update(model_flops=len(done) * refiner_flops.refine(ctx.config, t),
                        attn_flops=attn.flops, attn_bytes=attn.bytes,
                        ff_flops=ff.flops, ff_bytes=ff.bytes)
    del pipe
    models.free_cuda()

    checks = check_request(ctx, dev, plan, done)
    return Outcome(attempted=len(done), failed=0, end_to_end=e2e, checks=checks,
                   readings=readings, summary=window.summary() if ctx.trace else None,
                   memory_peak_bytes=peak)


def check_request(ctx: Run, dev, plan: list, done: list) -> list:
    """The images `check_images` of one request drawn from the seed, against
    the reference (on the seed's weights, drawn again) fed the same inputs:
    mean |program - reference| in uint8 levels of the images as the CLI
    writes them. With the traffic's "control" set, also the control: the
    reference itself at float8 in the program's place."""
    t = ctx.traffic
    gen = layouts.rng(ctx.seed, 2)
    j = int(gen.integers(len(done)))
    rows = strata(gen, t["num_images"], t["check_images"])
    _, i, got = done[j]
    req = plan[i] if i < len(plan) else refiner.request(ctx.seed, i, t, dev)
    dtype = torch.bfloat16 if torch.device(dev).type == "cuda" else torch.float32
    ref = refiner.reference(ctx.config, refiner.weights(ctx.config, ctx.seed, dev, dtype), dev)
    from port_bench.reference import core

    def images(precision):
        with core.fp32_matmuls(), core.precision(precision):
            return to_u8(ref.refine(np.asarray(req.images, np.float32) / 255.0, req.prompt,
                                    req.noise, rows, **options(t)))

    want = images("fp32")
    checks = [Check("mean_abs_u8", mean_abs(got[rows], want), float(t["limit_mean_abs_u8"]))]
    if t.get("control"):
        checks.append(Check("control.mean_abs_u8", mean_abs(images("fp8"), want),
                            float(t["limit_mean_abs_u8"])))
    return checks


class FFProbe:
    """A benchmark span around every feed-forward call of the port's UNet
    blocks (`models/unet._apply_ff_geglu`: the fused kernel or the unfused
    route, as `ff_geglu` picks), with the call's FLOPs and bytes from its
    shapes: the two products, and x, the output and the weights and biases
    read or written once."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0

    def __enter__(self):
        from instancediffusion_tpu_torch.models import unet

        self._mod, self._orig = unet, unet._apply_ff_geglu
        orig = self._orig

        def wrapped(p, x):
            c = x.shape[-1]
            rows = x.numel() // c
            inner = p.out.weight.shape[1]
            self.flops += flops.linear(rows, c, 2 * inner) + flops.linear(rows, inner, c)
            self.bytes += refiner_flops.ff_bytes(rows, c, inner, x.element_size())
            with trace.span("ff"):
                return orig(p, x)

        unet._apply_ff_geglu = wrapped
        return self

    def __exit__(self, *exc):
        self._mod._apply_ff_geglu = self._orig
        return False
