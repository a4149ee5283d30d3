"""Driver of `InstanceDiffusionPipeline.generate` traffic: requests of
`num_images` images on seeded layouts, run back to back.

Traffic keys: preset, use_masked_att, sampler, steps, mis, num_images,
instances (per layout), segs (instance masks with the layout), warmup_steps
(a short request over every shape the window uses), trace_requests (the
requests a traced run records), check_images (images of one request drawn
from the seed that the reference recomputes), limit_mean_abs_u8 (the
check's limit), planned_requests (layouts drawn before the window).

End-to-end: img_s, images of whole requests / (last completion - window
start), no request started after the window's length and every request
started fetched; setup_s.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from port_bench.harness import flops, layouts, models, trace
from port_bench.harness.context import Check, Outcome, Run
from port_bench.harness.layouts import strata
from port_bench.harness.stats import rate


def request_layout(ctx: Run, i: int) -> tuple[dict, int]:
    """Request i's layout and image seed."""
    t = ctx.traffic
    gen = layouts.rng(ctx.seed, 1, i)
    meta = layouts.layout(gen, t["instances"], segs=t.get("segs", False),
                          seg_size=ctx.config["config"]["model"]["grounding_tokenizer"]
                          ["seg_resize_input"])
    return meta, layouts.image_seed(gen)


def request_flops(ctx: Run, ref_cfg, meta: dict) -> float:
    """Model FLOPs of one request other than the UNet's attention products
    (which `AttentionProbe` counts at the call sites, labeled calls by
    their kept pairs): the text encode, every UNet forward of the sampler
    (CFG rows, MIS rows; gate 0 steps without the fuser) and the VAE
    decode."""
    from port_bench.reference import unifusion
    from port_bench.reference.schedules import alpha_generator

    t, c = ctx.traffic, ctx.config["config"]
    steps, b, k = t["steps"], t["num_images"], len(meta["phrases"])
    mis_step = int(steps * t["mis"]) if t["mis"] > 0 and k else 0
    traj = 1 + k if mis_step else 1
    alpha = ref_cfg.sampler.alpha
    gates = alpha_generator(steps, meta.get("alpha_type", [alpha, 0.0, 1 - alpha]))
    g_tokens = unifusion.num_grounding_tokens(ref_cfg.model.grounding_tokenizer,
                                              ref_cfg.model.max_objs)
    # PLMS runs one extra forward at its first step
    calls = list(enumerate(gates)) + ([(0, gates[0])] if t["sampler"] == "plms" else [])
    total = flops.text_encoder(c["text_encoder"], 2 + k)
    for i, g in calls:
        rows = 2 * b * (traj if i < mis_step else 1)
        total += (flops.unet_forward(c["model"], rows, g, g_tokens)
                  - flops.unet_forward(c["model"], rows, g, g_tokens, attn_only=True))
    return total + flops.vae_decode(c["autoencoder"], b, ref_cfg.model.image_size)


def run(ctx: Run) -> Outcome:
    t = ctx.traffic
    dev = torch.device(ctx.device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    w = models.sd15_weights(ctx.config, ctx.seed, dev, dtype)
    pipe = models.sd15_port(ctx.config, t, w, dev, dtype)
    del w  # the program holds its own copies; the reference draws them again
    kw = dict(num_images=t["num_images"], sampler=t["sampler"], mis=t["mis"])

    warm_meta, warm_seed = request_layout(ctx, 10**6)
    pipe.generate(warm_meta, steps=t["warmup_steps"], seed=warm_seed, **kw)
    # the window's layouts, drawn before it (later ones, if a window ever
    # holds more, are drawn as they are reached)
    plan = [request_layout(ctx, i) for i in range(t.get("planned_requests", 0))]

    if ctx.trace:
        trace.prime()
    attn = AttentionProbe() if ctx.trace else None
    n_trace = t.get("trace_requests", 1)
    window = trace.Window(ctx.trace)
    done, prep, marks = [], [], []
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    start = ctx.start_window()
    if cuda:
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record()

    def finish(item) -> None:
        handle, meta, seed = item
        imgs = handle.fetch()
        done.append((time.perf_counter(), meta, seed, imgs))

    # One request is dispatched ahead of the one waited for: its host work
    # (text encode, grounding rows, uploads) runs while the card finishes the
    # last. When the time is up nothing more is sent, and the window closes
    # once every request sent has been fetched.
    with window, (attn or contextlib.nullcontext()):
        i, inflight = 0, None
        while i < n_trace if ctx.trace else (i == 0 or time.perf_counter() - start < ctx.seconds):
            meta, seed = plan[i] if i < len(plan) else request_layout(ctx, i)
            if attn:
                attn.new_request()
            handle = pipe.generate(meta, steps=t["steps"], seed=seed, block=False, **kw)
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            prep.append(pipe.last_timings["text_encode"] + pipe.last_timings["grounding_prep"])
            if inflight:
                finish(inflight)
            inflight = (handle, meta, seed)
            i += 1
        finish(inflight)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    images = len(done) * t["num_images"]
    e2e = {"img_s": rate(images, start, done[-1][0])}
    if cuda:
        print("requests: device seconds", [round(a.elapsed_time(b) / 1e3, 4)
                                           for a, b in zip(marks, marks[1:])],
              "host prep seconds", [round(p, 4) for p in prep], file=sys.stderr)

    ref_cfg = models.sd15_ref_config(ctx.config, t)
    readings = {"host_prep_s": float(np.mean(prep)), "requests": len(done)}
    if ctx.trace:
        other = sum(request_flops(ctx, ref_cfg, m) for _, m, _, _ in done)
        readings.update(model_flops=other + attn.flops, attn_flops=attn.flops,
                        attn_bytes=attn.bytes)
    del pipe
    models.free_cuda()

    checks = check_request(ctx, dev, done)
    return Outcome(attempted=len(done), failed=0, end_to_end=e2e, checks=checks,
                   readings=readings, summary=window.summary() if ctx.trace else None,
                   memory_peak_bytes=peak)


def check_request(ctx: Run, dev, done: list) -> list:
    """The images `check_images` of one request drawn from the seed, against
    the reference (on the seed's weights, drawn again): mean |program -
    reference| in uint8 levels. With the traffic's "control" set, also the
    control: the reference itself at float8 in the program's place."""
    t = ctx.traffic
    gen = layouts.rng(ctx.seed, 2)
    j = int(gen.integers(len(done)))
    rows = strata(gen, t["num_images"], t["check_images"])
    _, meta, seed, imgs = done[j]
    dtype = torch.bfloat16 if torch.device(dev).type == "cuda" else torch.float32
    ref = models.sd15_reference(ctx.config, t, models.sd15_weights(ctx.config, ctx.seed, dev,
                                                                   dtype), dev)
    from port_bench.reference import core

    def images(precision):
        with core.fp32_matmuls(), core.precision(precision):
            return ref.generate(meta, t["num_images"], t["steps"], t["sampler"], t["mis"], seed,
                                rows)

    want = images("fp32")
    checks = [Check("mean_abs_u8", mean_abs(imgs[rows], want), float(t["limit_mean_abs_u8"]))]
    if t.get("control"):
        checks.append(Check("control.mean_abs_u8", mean_abs(images("fp8"), want),
                            float(t["limit_mean_abs_u8"])))
    return checks


def mean_abs(got: np.ndarray, want: np.ndarray) -> float:
    """Mean |got - want| over every pixel and channel."""
    return float(np.abs(got.astype(np.float64) - want.astype(np.float64)).mean())


class AttentionProbe:
    """A benchmark span around every attention call of the port's UNet (the
    `multi_head_attention` that `models/unet.py` calls), with the call's
    FLOPs and bytes from the shapes that reach it (labeled calls: the kept
    pairs of their labels)."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self._kept: dict = {}

    def __enter__(self):
        from instancediffusion_tpu_torch.models import unet

        self._mod, self._orig = unet, unet.multi_head_attention
        orig = self._orig

        def wrapped(q, k, v, num_heads, mask=None, labels=None, **kw):
            b, n, c = q.shape
            m = k.shape[1]
            if labels is not None:
                pairs = self._kept_pairs(labels, n, m)
                self.flops += 4.0 * c * pairs
                self.bytes += flops.attention_bytes(b, n, m, c, label_rows=labels[0].shape[1])
            else:
                self.flops += b * flops.attention(n, m, c)
                self.bytes += flops.attention_bytes(b, n, m, c)
            with trace.span("attn"):
                return orig(q, k, v, num_heads, mask=mask, labels=labels, **kw)

        unet.multi_head_attention = wrapped
        return self

    def __exit__(self, *exc):
        self._mod.multi_head_attention = self._orig
        return False

    def new_request(self) -> None:
        """Forget the label tensors of the last request (their memory may
        hold the next request's labels)."""
        self._kept.clear()

    def _kept_pairs(self, labels, n: int, m: int) -> float:
        """Kept (query, key) pairs over the batch. The same label tensors
        serve every step of a request, so each is read once a request, and
        each distinct row once."""
        from port_bench.reference.attention import labels_to_dense

        key = (labels[0].data_ptr(), labels[1].data_ptr(), tuple(labels[0].shape), n, m)
        if key not in self._kept:
            bits, open_ = (t.cpu() for t in labels)
            rows: dict = {}
            total = 0.0
            for r in range(bits.shape[0]):
                rk = bits[r].numpy().tobytes() + open_[r].numpy().tobytes()
                if rk not in rows:
                    rows[rk] = float(labels_to_dense(bits[r:r + 1], open_[r:r + 1])
                                     [0, 0, :n, :m].sum())
                total += rows[rk]
            self._kept[key] = total
        return self._kept[key]
