"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, in order (each prints its lines; any failure exits non-zero):
  device     require CUDA; print the card's name and power limit (nvidia-smi)
  build      build the hand-written kernels from csrc/ with nvcc
  kernels    each kernel against its plain PyTorch version at the paths'
             per-sample shapes (batch 2), in bf16 (LayerNorm also on the fp32
             ConvNeXt rows; attention also with instance labels from META's
             boxes, one sample masked and one open): max abs / relative error
             against the stated tolerance, median kernel and plain times;
             then the redesigned kernels at the main path's own batches
             (attention and GroupNorm at the UNet's B=16, the training
             forward and the backward kernels dq and dk/dv, plain and
             labeled, at B=4 with SDPA's backward as their library time,
             GroupNorm at the VAE decoder's B=8, the fused projection
             kernels K8 / K8' at the served B=16 beside F.linear), each held
             to its plain version and timed by device time (the kernels'
             durations in torch.profiler over 20 back-to-back launches),
             beside events around those 20 launches, one wrapper-timed call,
             the library call's device time and the share of the bound
  grounding  UniFusion in fp32 (ConvNeXt's LayerNorms through the kernel) on
             the slice's layout with random phrase embeddings and instance
             masks, seg tokens kept, kernels vs plain_kernels()
  unet       full-width UNet forwards (B=2, gate 1.0, those 184 grounding
             tokens) on densified random weights, kernels vs plain_kernels():
             unmasked, and with the ds1 fusers masked by META's box labels
  slice      random_init + densify + generate (8 images, 50-step PLMS, 4
             instances, mis=0, bf16): warm-up, then timed requests; checks the
             output and that every kernel of the path launched during the
             timed run
  mis        the same weights under the "mask" preset with use_masked_att
             and META's instance masks: generate (8 images, 50 steps,
             mis=0.36: Multi-Instance Sampler over 5 trajectories, fuser
             masked by instance labels), warm-up then timed requests, with
             the same checks
  fused      the B=16 gate-1 UNet forward (the CFG batch of 8 images) with
             the ds1 attentions on the FUSED_PROJ route (proj_split, flash
             attention, merge_proj) against the unfused route, both on the
             kernels: error, both times on the host clock and both device
             times (off, on, on, off)
  serve      serve(port=0, DPM-Solver++ 20 steps, batch 8, mis=0) on the
             same weights, FUSED_PROJ on: warm-up, 2 x 8 concurrent POSTs,
             then a burst of 16; every reply a 512x512 PNG; p50 latency,
             img/s, s/batch and launches per batch against the expected
             counts; then the same with FUSED_PROJ off
  ddim       generate with DDIM (20 steps, B=8), then img2img of one of its
             images (strength 0.5 of 50 PLMS steps, B=8): two requests each,
             s/image and launches
  train      the training step at full width (Config(), B=4 at 512 px, 30
             objects, the batch bench.py builds from numpy seed 0, densified
             weights, frozen weights bf16, remat on): (a) one step's loss
             and trainable gradients with the kernels against
             plain_kernels(), per parameter group; (b) every trainable
             gradient finite, every group's non-zero, no frozen gradient;
             (c) 2 warm-up and 10 timed steps: s/step, samples/s, peak
             memory, launches per step against the expected counts; (d) the
             "mask" preset with use_masked_att: 3 steps through the labeled
             trainable kernels
The kernels phase also holds the training kernels (forward with
log-sum-exp, dq, dk/dv, unlabeled and labeled) against their plain versions
at the training shapes. Every kernel line gives its time, its plain
version's, a PyTorch library call's where one computes the same function
(`library_ms`; a yardstick only, the port never calls it) and its bound:
the larger of its FLOPs over 989 TFLOP/s (bf16 tensor cores; 67 TFLOP/s
fp32 for the norms) and its bytes (each input read once, each output
written once) over 3.35 TB/s, the H100 SXM's published peaks. Attention
lines also give `exp_bound_ms`: the kept scores, one exp2 each, over 16
exp2 per clock per SM on 132 SMs at the card's maximum SM clock
(`nvidia-smi --query-gpu=clocks.max.sm`); at head dim 40 it is the higher
of the two bounds.
Then the card's nvidia-smi line, one JSON line describing the kernels and,
last, the device line {"ok": true, "device": {...}}.

Weights are random (seeded); the hash tokenizer stands in for CLIP's BPE
files. nvcc's log (with -Xptxas -v register counts) is written beside the
built library, in build/instancediffusion_tpu_torch/<hash>/build.log.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

STEPS = 50
N_IMAGES = 8

META = {
    "prompt": "a cat and a dog and a robin sitting on a wooden bench in a park",
    "phrases": ["a cat", "a dog", "a robin", "a wooden bench"],
    "locations": [
        [0.05, 0.35, 0.45, 0.90],
        [0.55, 0.30, 0.95, 0.90],
        [0.42, 0.05, 0.58, 0.25],
        [0.02, 0.55, 0.98, 0.98],
    ],
    "points": [[0.25, 0.62], [0.75, 0.60], [0.50, 0.15], [0.50, 0.76]],
    "alpha_type": [0.75, 0.0, 0.25],
}

# where each kernel lives and which TPU kernel it replaces; the labeled
# entries are the same CUDA kernel's LABELED instantiation
KERNELS = {
    "flash_attention": (
        "cuda", "instancediffusion_tpu_torch/csrc/flash_fwd_sm90.cuh",
        "instancediffusion_tpu/kernels/flash_attention.py:213"),
    "flash_attention_labeled": (
        "cuda", "instancediffusion_tpu_torch/csrc/flash_fwd_sm90.cuh",
        "instancediffusion_tpu/kernels/flash_attention.py:271"),
    "flash_attention_packed": (
        "cuda", "instancediffusion_tpu_torch/csrc/flash_fwd_sm90.cuh",
        "instancediffusion_tpu/kernels/flash_attention.py:448"),
    "flash_attention_packed_labeled": (
        "cuda", "instancediffusion_tpu_torch/csrc/flash_fwd_sm90.cuh",
        "instancediffusion_tpu/kernels/flash_attention.py:508"),
    "fused_group_norm": (
        "cuda", "instancediffusion_tpu_torch/csrc/norms.cu",
        "instancediffusion_tpu/kernels/norms.py:125"),
    "fused_layer_norm": (
        "cuda", "instancediffusion_tpu_torch/csrc/norms.cu",
        "instancediffusion_tpu/kernels/norms.py:210"),
    "fused_ff_geglu": (
        "cuda", "instancediffusion_tpu_torch/csrc/geglu_ff.cu",
        "instancediffusion_tpu/kernels/geglu_ff.py:63"),
    "flash_attention_trainable": (
        "cuda", "instancediffusion_tpu_torch/csrc/flash_fwd_sm90.cuh",
        "instancediffusion_tpu/kernels/flash_attention.py:539"),
    "flash_attention_trainable_labeled": (
        "cuda", "instancediffusion_tpu_torch/csrc/flash_fwd_sm90.cuh",
        "instancediffusion_tpu/kernels/flash_attention.py:580"),
    "flash_attention_bwd_dq": (
        "cuda", "instancediffusion_tpu_torch/csrc/flash_bwd_sm90.cuh",
        "instancediffusion_tpu/kernels/flash_attention.py:594"),
    "flash_attention_bwd_dq_labeled": (
        "cuda", "instancediffusion_tpu_torch/csrc/flash_bwd_sm90.cuh",
        "instancediffusion_tpu/kernels/flash_attention.py:753"),
    "flash_attention_bwd_dkv": (
        "cuda", "instancediffusion_tpu_torch/csrc/flash_bwd_sm90.cuh",
        "instancediffusion_tpu/kernels/flash_attention.py:651"),
    "flash_attention_bwd_dkv_labeled": (
        "cuda", "instancediffusion_tpu_torch/csrc/flash_bwd_sm90.cuh",
        "instancediffusion_tpu/kernels/flash_attention.py:793"),
    "proj_split": (
        "cuda", "instancediffusion_tpu_torch/csrc/head_layout.cu",
        "instancediffusion_tpu/kernels/head_layout.py:96"),
    "merge_proj": (
        "cuda", "instancediffusion_tpu_torch/csrc/head_layout.cu",
        "instancediffusion_tpu/kernels/head_layout.py:178"),
}

# kernel vs plain: max |kernel - plain| <= tol * max |plain|. Both sides
# take the same inputs; the plain versions compute in fp32 and round once.
# In bf16, GN/LN differ only in summation order (<= 1-2 bf16 ulps);
# attention rounds the probabilities and FF the gated intermediate to bf16
# before the second product (relative error ~2^-9 per term).
BF16_REL_TOL = 1e-2
# fp32 LayerNorm rows (ConvNeXt): fp32 summation order only
FP32_REL_TOL = 1e-5
# grounding tokens, fp32 both ways: only the ConvNeXt LayerNorms' fp32
# summation order differs, carried through 18 blocks and the token MLPs
GROUNDING_REL_TOL = 1e-4
UNET_REL_TOL = 5e-2  # whole bf16 UNet, kernels vs plain (rel. to max |eps|)
# training kernels: dq/dk/dv in bf16 against fp32 plain versions; ds and p
# are rounded to bf16 before their products (relative error ~2^-9 per
# term, summed over thousands of keys or rows)
GRAD_REL_TOL = 2e-2
LSE_ATOL = 1e-3  # fp32 log-sum-exp (base 2): summation order only
# whole training step, kernels vs plain_kernels(), bf16 activations: the
# loss, and per parameter group ||g_kernel - g_plain|| / ||g_plain||
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_REL_TOL = 5e-2
TRAIN_B = 4
# the training step's long attentions: (label, N, M, head dim, labeled)
TRAIN_ATTN = (("ds1 self 4096x4096", 4096, 4096, 40, False),
              ("ds1 fuser 4096x4280", 4096, 4280, 40, False),
              ("ds2 self 1024x1024", 1024, 1024, 80, False),
              ("ds2 fuser 1024x1208", 1024, 1208, 80, False),
              ("ds1 fuser 4096x4280 labeled", 4096, 4280, 40, True))
TRAIN_IMAGE = 512
TRAIN_STEPS = 10
# launches per full-width training step with remat: 20 long attentions per
# forward (10 self + 10 fuser at ds1 and ds2), the forward run twice; 19
# backwards, because the first ds1 self-attention comes before every
# trainable parameter (its inputs need no gradient, so autograd skips its
# backward; the JAX step differentiates the frozen weights too and runs
# all 20)
TRAIN_LAUNCHES = {"flash_attention_trainable": 40, "flash_attention_bwd_dq": 19,
                  "flash_attention_bwd_dkv": 19}
# with use_masked_att the 5 ds1 fusers take the labeled kernels
MASKED_LAUNCHES = {"flash_attention_trainable": 30, "flash_attention_trainable_labeled": 10,
                   "flash_attention_bwd_dq": 14, "flash_attention_bwd_dq_labeled": 5,
                   "flash_attention_bwd_dkv": 14, "flash_attention_bwd_dkv_labeled": 5}

# the H100 SXM's published peaks (dense): bf16 tensor cores, fp32 without
# them, HBM3
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# exp2 (MUFU.EX2) per clock per SM, and the H100 SXM's SMs
EX2_PER_CLOCK_SM = 16
SMS = 132
MAIN_REPS = 20  # back-to-back launches per device-time measurement
# GroupNorm shapes (rows, C, eps, act) of the B=16 gate-1 UNet forward and
# of the VAE decoder at B=8 (decoding 8 images), as the path passes them
GN_UNET_B16 = ((4096, 320, 1e-5, "silu"), (4096, 320, 1e-6, "none"), (4096, 640, 1e-5, "silu"),
               (4096, 960, 1e-5, "silu"), (1024, 320, 1e-5, "silu"), (1024, 640, 1e-5, "silu"),
               (1024, 640, 1e-6, "none"), (1024, 960, 1e-5, "silu"), (1024, 1280, 1e-5, "silu"),
               (1024, 1920, 1e-5, "silu"), (256, 640, 1e-5, "silu"), (256, 1280, 1e-5, "silu"),
               (256, 1280, 1e-6, "none"), (256, 1920, 1e-5, "silu"), (256, 2560, 1e-5, "silu"),
               (64, 1280, 1e-5, "silu"), (64, 1280, 1e-6, "none"), (64, 2560, 1e-5, "silu"))
# LayerNorm rows (rows per sample, C) of the B=16 gate-1 UNet forward: the
# transformer blocks' and the fusers' [x | objs] rows at ds1, ds2, ds4
LN_UNET_B16 = ((4096, 320), (4280, 320), (1024, 640), (1208, 640), (256, 1280), (440, 1280))
# the feed-forwards of that forward: ds1 and ds2 (C=640, clusters of two
# blocks) fit the fused kernel; ds4 and ds8 (C=1280) go to the unfused route
# (`ff_fits`): 10 + 10 and 10 + 2
FF_KERNEL = ((4096, 320), (1024, 640))
FF_UNFUSED = ((256, 1280), (64, 1280))
GN_VAE_B8 = ((4096, 512, 1e-6, "silu"), (4096, 512, 1e-6, "none"), (16384, 512, 1e-6, "silu"),
             (65536, 256, 1e-6, "silu"), (65536, 512, 1e-6, "silu"), (262144, 128, 1e-6, "silu"),
             (262144, 256, 1e-6, "silu"))

# kernels each path must launch in its timed requests; no path of either
# package reaches flash_attention_packed_labeled (labels exist at ds1 only,
# where the head dim is 40 and attention is split-heads), so it is checked
# in the kernels phase only
PLAIN_PATH = ("flash_attention", "flash_attention_packed", "fused_group_norm",
              "fused_layer_norm", "fused_ff_geglu")
# the feed-forward switch (`ff_fits`): a gate-1 forward runs 20 feed-forwards
# in the fused kernel (10 at ds1, 10 at ds2) and 12 on the unfused route (10
# at ds4 and 2 at ds8, C=1280); a gate-0 forward skips the fusers' and runs 10
# and 6. Per PLMS-50 request at alpha 0.75 (38 gate-1 + 13 gate-0 forwards),
# per DPM-20 batch (15 + 5) and per training step (the forward twice, remat)
FF_ROUTE = "ff_geglu_unfused"
FF_PER_REQUEST = {"fused_ff_geglu": 38 * 20 + 13 * 10, FF_ROUTE: 38 * 12 + 13 * 6}
FF_PER_BATCH = {"fused_ff_geglu": 15 * 20 + 5 * 10, FF_ROUTE: 15 * 12 + 5 * 6}
FF_PER_STEP = {"fused_ff_geglu": 2 * 20, FF_ROUTE: 2 * 12}
MIS_PATH = PLAIN_PATH + ("flash_attention_labeled",)
TRAIN_PATH = tuple(TRAIN_LAUNCHES) + ("fused_group_norm", "fused_layer_norm", "fused_ff_geglu")
MASKED_TRAIN_PATH = tuple(MASKED_LAUNCHES)
# the serving path: generate_batch with DPM-Solver++ at 20 steps, batch 8
# (`python -m instancediffusion_tpu_torch.serve --steps 20 --sampler dpm
# --batch_size 8`). Per batch at alpha 0.75: 15 gate-1 forwards (5 ds1
# self-attentions + 5 ds1 fusers each) and 5 gate-0 forwards (5 self);
# on the FUSED_PROJ route each ds1 attention is 2 proj_split launches (q,
# then k and v) and one merge_proj
SERVE_STEPS = 20
SERVE_B = 8
SERVE_LAUNCHES = {"flash_attention": 175, "proj_split": 350, "merge_proj": 175}
SERVE_PATH = PLAIN_PATH + ("proj_split", "merge_proj")
FUSED_UNET_B = 16
DS1_ATTENTIONS = 10  # per gate-1 forward: 5 ds1 self-attentions + 5 ds1 fusers
ONLY_KERNELS_PHASE = {"flash_attention_packed_labeled": "kernels phase only: no path reaches it"}


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm, MHz)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def device_ms(torch, fn, reps: int = MAIN_REPS) -> float:
    """Device time per call: the summed durations of every kernel that
    `reps` back-to-back calls launch (torch.profiler), over reps. Raises if
    the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(10):  # CUPTI now and then delivers no kernel record: measure again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
        if us > 0:
            return us / 1e3 / reps
    raise RuntimeError("device_ms: the profiler saw no device time")


def events_ms(torch, fn, reps: int = MAIN_REPS) -> float:
    """CUDA events around `reps` back-to-back calls, per call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# kernels vs plain
# ---------------------------------------------------------------------------


def meta_labels(torch, dev, size: int, n_objs: int = 30, seg_tokens: int = 64):
    """(bits, open) int32 (2, size**2 + 4*n_objs + seg_tokens) fuser labels:
    sample 0 from the rasters of META's boxes, sample 1 with no instance
    (fully open, as the CFG null half is)."""
    from instancediffusion_tpu_torch.kernels.flash_attention import instance_labels
    from instancediffusion_tpu_torch.ops.instance_mask import rasterize_boxes

    boxes = torch.zeros(2, n_objs, 4, device=dev)
    boxes[0, :len(META["locations"])] = torch.tensor(META["locations"], device=dev)
    return instance_labels(rasterize_boxes(boxes, size), n_objs, seg_tokens)


def meta_segs(size: int = 512):
    """One filled ellipse inside each of META's boxes, (size, size) float32
    instance masks (rows y, columns x)."""
    import numpy as np

    yy, xx = np.mgrid[0:size, 0:size] / size
    segs = []
    for x1, y1, x2, y2 in META["locations"]:
        cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
        segs.append(((((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2) <= 1).astype(np.float32))
    return segs


def _exp_bound(exps: float, clock_hz: float) -> float:
    """Least ms for `exps` exp2 evaluations on the card's MUFU units."""
    return exps / (EX2_PER_CLOCK_SM * SMS * clock_hz) * 1e3


def _bound(flops: float, nbytes: float, peak: float = PEAK_BF16) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _attn_work(kind, b, h, n, m, c, mask=None):
    """(FLOPs, bytes, exp2 count) of one attention kernel call. kind: "fwd"
    (q k^T and p v), "fwd_lse" (also writes lse), "dq" (s, dp, dq) or "dkv"
    (s, dp, dv, dk); each computes one exp2 per kept score. Labeled calls
    count the kept (q, key) pairs only; bf16 operands, fp32 lse and delta,
    int32 labels."""
    pairs = b * n * m if mask is None else int(mask.sum().item())
    n_mm = {"fwd": 2, "fwd_lse": 2, "dq": 3, "dkv": 4}[kind]
    rows = {"fwd": 2 * n + 2 * m, "fwd_lse": 2 * n + 2 * m, "dq": 3 * n + 2 * m,
            "dkv": 2 * n + 4 * m}[kind]  # q/out/dO/dq rows, k/v/dk/dv rows
    nbytes = 2 * b * h * c * rows
    nbytes += {"fwd": 0, "fwd_lse": 4, "dq": 8, "dkv": 8}[kind] * b * h * n
    if mask is not None:
        nbytes += 8 * b * max(n, m)
    return 2 * n_mm * h * pairs * c, nbytes, h * pairs


def _close(out, ref, tol, lse_at=None):
    """(max abs err, max abs err / max |ref|, ok) of a tensor or a tuple;
    the tuple entry at `lse_at` (fp32 log-sum-exp) is held to LSE_ATOL
    instead."""
    outs, refs = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    err = rel = 0.0
    ok = True
    for i, (o, r) in enumerate(zip(outs, refs)):
        if o.shape != r.shape or not bool(o.float().isfinite().all()):
            return float("inf"), float("inf"), False
        e = (o.float() - r.float()).abs().max().item()
        if i == lse_at:
            ok &= e <= LSE_ATOL
            continue
        err, rel = max(err, e), max(rel, e / max(r.float().abs().max().item(), 1e-12))
        ok &= e <= tol * r.float().abs().max().item()
    return err, rel, ok


def _cases(torch, dev):
    """Case dicts: name, label, kern, plain, tol, work (FLOPs, bytes,
    peak) and library (one PyTorch call computing the same function, or
    None), at the paths' per-sample shapes, batch 2."""
    import torch.nn.functional as F

    from instancediffusion_tpu_torch.kernels import flash_attention as fa
    from instancediffusion_tpu_torch.kernels import geglu_ff as ff
    from instancediffusion_tpu_torch.kernels import norms
    from instancediffusion_tpu_torch.ops.attention import labels_to_dense, sdpa_fp32

    g = torch.Generator(device=dev).manual_seed(0)
    bf, fp = torch.bfloat16, torch.float32
    sdpa = F.scaled_dot_product_attention

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    def case(name, label, kern, plain, tol, work, library, peak=PEAK_BF16):
        return dict(name=name, label=label, kern=kern, plain=plain, tol=tol,
                    work=(*work[:2], peak), exps=work[2] if len(work) > 2 else None,
                    library=library)

    cases = []
    # split-heads attention at ds1 (c=40): head views of (B,N,H*c)
    # projections, as the UNet passes them; fuser over the unpadded 4280
    # keys and over 4608 pre-padded keys with kv_len=4280
    heads40 = lambda t: t.reshape(2, t.shape[1], 8, 40).transpose(1, 2)
    heads80 = lambda t: t.reshape(2, t.shape[1], 8, 80).transpose(1, 2)
    for label, n, m, kv_len in (("self 4096x4096", 4096, 4096, None),
                                ("fuser 4096x4280", 4096, 4280, None),
                                ("fuser 4096x4608 kv_len=4280", 4096, 4608, 4280)):
        q, k, v = randn(2, n, 320), randn(2, m, 320), randn(2, m, 320)
        qh, kh, vh = heads40(q), heads40(k), heads40(v)
        mm = m if kv_len is None else kv_len
        cases.append(case(
            "flash_attention", label,
            lambda qh=qh, kh=kh, vh=vh, kv=kv_len: fa.flash_attention(qh, kh, vh, kv_len=kv),
            lambda qh=qh, kh=kh, vh=vh, mm=mm: sdpa_fp32(qh, kh[:, :, :mm], vh[:, :, :mm]),
            BF16_REL_TOL, _attn_work("fwd", 2, 8, n, mm, 40),
            lambda qh=qh, kh=kh, vh=vh, mm=mm: sdpa(qh, kh[:, :, :mm], vh[:, :, :mm])))
    # the masked ds1 fuser: labels of META's boxes at 64x64 (one sample
    # masked, one open), over 4280 keys and over 4608 with kv_len=4280
    labels64 = meta_labels(torch, dev, 64)
    for label, m, kv_len in (("fuser 4096x4280 labeled", 4280, 4280),
                             ("fuser 4096x4608 kv_len=4280 labeled", 4608, 4280)):
        q, k, v = randn(2, 4096, 320), randn(2, m, 320), randn(2, m, 320)
        qh, kh, vh = heads40(q), heads40(k), heads40(v)
        mask = labels_to_dense(*labels64)[:, :, :4096, :kv_len]
        cases.append(case(
            "flash_attention_labeled", label,
            lambda qh=qh, kh=kh, vh=vh, kv=kv_len: fa.flash_attention(
                qh, kh, vh, labels=labels64, kv_len=kv),
            lambda qh=qh, kh=kh, vh=vh, kv=kv_len, mask=mask: sdpa_fp32(
                qh, kh[:, :, :kv], vh[:, :, :kv], mask=mask),
            BF16_REL_TOL, _attn_work("fwd", 2, 8, 4096, kv_len, 40, mask),
            lambda qh=qh, kh=kh, vh=vh, kv=kv_len, mask=mask: sdpa(
                qh, kh[:, :, :kv], vh[:, :, :kv], attn_mask=mask)))
    # packed attention at ds2 (c=80)
    for label, n, m, kv_len in (("self 1024x1024", 1024, 1024, None),
                                ("fuser 1024x1208", 1024, 1208, None),
                                ("fuser 1024x1536 kv_len=1208", 1024, 1536, 1208)):
        q, k, v = randn(2, n, 640), randn(2, m, 640), randn(2, m, 640)
        mm = m if kv_len is None else kv_len

        def plain(q=q, k=k, v=v, mm=mm):
            out = sdpa_fp32(heads80(q), heads80(k[:, :mm]), heads80(v[:, :mm]))
            return out.transpose(1, 2).reshape(2, q.shape[1], 640)

        cases.append(case(
            "flash_attention_packed", label,
            lambda q=q, k=k, v=v, kv=kv_len: fa.flash_attention_packed(q, k, v, 8, kv_len=kv),
            plain, BF16_REL_TOL, _attn_work("fwd", 2, 8, n, mm, 80),
            lambda q=q, k=k, v=v, mm=mm: sdpa(heads80(q), heads80(k[:, :mm]),
                                              heads80(v[:, :mm]))))
    # packed attention with labels of META's boxes at a 32x32 raster (1024
    # visual + 184 grounding keys)
    labels32 = meta_labels(torch, dev, 32)
    q, k, v = randn(2, 1024, 640), randn(2, 1208, 640), randn(2, 1208, 640)
    mask32 = labels_to_dense(*labels32)[:, :, :1024, :1208]

    def plain_packed_labeled(q=q, k=k, v=v):
        out = sdpa_fp32(heads80(q), heads80(k), heads80(v), mask=mask32)
        return out.transpose(1, 2).reshape(2, 1024, 640)

    cases.append(case(
        "flash_attention_packed_labeled", "1024x1208 labeled (32x32 raster)",
        lambda q=q, k=k, v=v: fa.flash_attention_packed(q, k, v, 8, labels=labels32),
        plain_packed_labeled, BF16_REL_TOL, _attn_work("fwd", 2, 8, 1024, 1208, 80, mask32),
        lambda q=q, k=k, v=v: sdpa(heads80(q), heads80(k), heads80(v), attn_mask=mask32)))
    # GroupNorm: UNet (eps 1e-5 res/out with SiLU, 1e-6 transformer) and
    # VAE decoder rows (eps 1e-6); ~8 fp32 operations per element. The
    # library call, F.group_norm, has no fused SiLU
    for n, c, eps, act in ((4096, 320, 1e-5, "silu"), (4096, 320, 1e-6, "none"),
                           (4096, 960, 1e-5, "silu"), (1024, 640, 1e-5, "silu"),
                           (256, 1280, 1e-5, "silu"), (64, 2560, 1e-5, "silu"),
                           (262144, 128, 1e-6, "silu"), (65536, 256, 1e-6, "silu"),
                           (4096, 512, 1e-6, "none")):
        x = randn(2, n, c, std=3.0) + 0.5
        sc, bi = randn(c), randn(c)
        cases.append(case(
            "fused_group_norm", f"({n},{c}) eps={eps} {act}",
            lambda x=x, sc=sc, bi=bi, e=eps, a=act: norms.fused_group_norm(x, sc, bi, 32, e, a),
            lambda x=x, sc=sc, bi=bi, e=eps, a=act: norms.group_norm_plain(x, sc, bi, 32, e, a),
            BF16_REL_TOL, (8 * 2 * n * c, 2 * 2 * n * c * 2 + 8 * c),
            lambda x=x, sc=sc, bi=bi, e=eps: F.group_norm(x.transpose(1, 2), 32, sc, bi, e),
            PEAK_FP32))
    # LayerNorm: bf16 UNet rows incl. fuser concat rows and CLIP; fp32
    # ConvNeXt rows (the grounding tokenizer runs in fp32, at batch 1)
    for n, c, eps, dt in ((4096, 320, 1e-5, bf), (4280, 320, 1e-5, bf),
                          (1208, 640, 1e-5, bf), (256, 1280, 1e-5, bf),
                          (440, 1280, 1e-5, bf), (77, 768, 1e-5, bf),
                          (16384, 96, 1e-6, fp), (4096, 192, 1e-6, fp),
                          (1024, 384, 1e-6, fp), (256, 768, 1e-6, fp)):
        x = (randn(2, n, c, std=2.0, dtype=dt) + 0.3).to(dt)
        sc, bi = randn(c), randn(c)
        cases.append(case(
            "fused_layer_norm", f"({n},{c}) eps={eps} {str(dt)[6:]}",
            lambda x=x, sc=sc, bi=bi, e=eps: norms.fused_layer_norm(x, sc, bi, e),
            lambda x=x, sc=sc, bi=bi, e=eps: norms.layer_norm_plain(x, sc, bi, e),
            BF16_REL_TOL if dt == bf else FP32_REL_TOL,
            (8 * 2 * n * c, 2 * 2 * n * c * x.element_size() + 8 * c),
            lambda x=x, sc=sc, bi=bi, e=eps: F.layer_norm(x, (x.shape[-1],), sc.to(x.dtype),
                                                          bi.to(x.dtype), e),
            PEAK_FP32))
    # GEGLU FF at the widths `ff_fits` gives the kernel (ds1, ds2; the C=1280
    # levels are held against the plain version in the routes phase); no one
    # PyTorch call computes it, so the library time is the unfused route's
    # three calls (two F.linear and a * gelu(g) in bf16), named so in its line
    for n, c in FF_KERNEL:
        cases.append(_ff_case(randn, case, 2, n, c))
    cases += _head_layout_cases(torch, randn, case)
    cases += _train_cases(torch, dev, randn, case, labels64)
    cases += _main_cases(torch, dev, randn, case)
    return cases


def _ff_args(randn, m, c):
    inner = 4 * c
    return (randn(m, c), randn(2 * inner, c, std=c ** -0.5), randn(2 * inner, std=0.1),
            randn(c, inner, std=inner ** -0.5), randn(c, std=0.1))


def _ff_work(m, c):
    """FLOPs and bytes of one feed-forward call: both products; x read and
    out written once, both weights and both biases (bf16) read once."""
    inner = 4 * c
    return 6 * m * c * inner, 2 * (2 * m * c + 3 * inner * c) + 2 * (2 * inner + c)


def _ff_case(randn, case, b, n, c):
    from instancediffusion_tpu_torch.kernels import geglu_ff as ff

    args = _ff_args(randn, b * n, c)
    args = (args[0].reshape(b, n, c),) + args[1:]
    cs = case("fused_ff_geglu", f"({b},{n},{c}) inner={4 * c}",
              lambda: ff.fused_ff_geglu(*args), lambda: ff.ff_geglu_plain(*args),
              BF16_REL_TOL, _ff_work(b * n, c), lambda: ff.ff_geglu_unfused(*args))
    cs["library_name"] = "unfused route: F.linear, a*gelu(g), F.linear in bf16"
    return cs


def _main_cases(torch, dev, randn, case):
    """The redesigned kernels at the batches the main path gives them: K1,
    K1-L and K2 at the UNet's B=16 (CFG over 8 images), K6 at the training
    batch, K3 at every GroupNorm shape of the B=16 UNet forward and of the
    VAE decoder at B=8. Library calls: SDPA (forward with inputs that need
    gradients, for K6); F.group_norm (+ F.silu) on a contiguous (B, C, N)
    copy made beforehand, so the yardstick pays no relayout."""
    import torch.nn.functional as F

    from instancediffusion_tpu_torch.kernels import flash_attention as fa
    from instancediffusion_tpu_torch.kernels import norms
    from instancediffusion_tpu_torch.ops.attention import labels_to_dense, sdpa_fp32

    sdpa = F.scaled_dot_product_attention
    b = FUSED_UNET_B
    heads = lambda t, c: t.reshape(t.shape[0], t.shape[1], 8, c).transpose(1, 2)
    cases = []
    for label, m, kv_len in (("self 4096x4096", 4096, None), ("fuser 4096x4280", 4280, None),
                             ("fuser 4096x4608 kv_len=4280", 4608, 4280)):
        qh, kh, vh = (heads(randn(b, s, 320), 40) for s in (4096, m, m))
        mm = m if kv_len is None else kv_len
        cases.append(case(
            "flash_attention", f"B={b} {label}",
            lambda qh=qh, kh=kh, vh=vh, kv=kv_len: fa.flash_attention(qh, kh, vh, kv_len=kv),
            lambda qh=qh, kh=kh, vh=vh, mm=mm: sdpa_fp32(qh, kh[:, :, :mm], vh[:, :, :mm]),
            BF16_REL_TOL, _attn_work("fwd", b, 8, 4096, mm, 40),
            lambda qh=qh, kh=kh, vh=vh, mm=mm: sdpa(qh, kh[:, :, :mm], vh[:, :, :mm])))
    # META's labels on the 8 conditional rows, open labels on the 8 unconditional
    bits, open_ = meta_labels(torch, dev, 64)
    labels = (bits.repeat_interleave(b // 2, 0), open_.repeat_interleave(b // 2, 0))
    mask = labels_to_dense(*labels)[:, :, :4096, :4280]
    qh, kh, vh = (heads(randn(b, s, 320), 40) for s in (4096, 4280, 4280))
    cases.append(case(
        "flash_attention_labeled", f"B={b} fuser 4096x4280 labeled",
        lambda: fa.flash_attention(qh, kh, vh, labels=labels),
        lambda: sdpa_fp32(qh, kh, vh, mask=mask), BF16_REL_TOL,
        _attn_work("fwd", b, 8, 4096, 4280, 40, mask),
        lambda: sdpa(qh, kh, vh, attn_mask=mask)))
    for label, m in (("self 1024x1024", 1024), ("fuser 1024x1208", 1208)):
        q, k, v = randn(b, 1024, 640), randn(b, m, 640), randn(b, m, 640)

        def plain(q=q, k=k, v=v):
            out = sdpa_fp32(heads(q, 80), heads(k, 80), heads(v, 80))
            return out.transpose(1, 2).reshape(b, 1024, 640)

        cases.append(case(
            "flash_attention_packed", f"B={b} {label}",
            lambda q=q, k=k, v=v: fa.flash_attention_packed(q, k, v, 8), plain, BF16_REL_TOL,
            _attn_work("fwd", b, 8, 1024, m, 80),
            lambda q=q, k=k, v=v: sdpa(heads(q, 80), heads(k, 80), heads(v, 80))))
    for label, n, m, c in (("ds1 self 4096x4096", 4096, 4096, 40),
                           ("ds1 fuser 4096x4280", 4096, 4280, 40),
                           ("ds2 self 1024x1024", 1024, 1024, 80),
                           ("ds2 fuser 1024x1208", 1024, 1208, 80)):
        q, k, v = (heads(randn(TRAIN_B, s, 8 * c), c) for s in (n, m, m))
        need = [t.detach().requires_grad_(True) for t in (q, k, v)]
        cases.append(case(
            "flash_attention_trainable", f"B={TRAIN_B} {label}",
            lambda q=q, k=k, v=v: fa.flash_attention_fwd_lse(q, k, v),
            lambda q=q, k=k, v=v: fa.flash_attention_fwd_lse_plain(q, k, v),
            BF16_REL_TOL, _attn_work("fwd_lse", TRAIN_B, 8, n, m, c),
            lambda need=need: sdpa(*need)))
        cases[-1]["lse_at"] = 1
    cases += _bwd_main_cases(torch, dev, randn, case, heads)
    for bb, shapes in ((b, GN_UNET_B16), (N_IMAGES, GN_VAE_B8)):
        for n, c, eps, act in shapes:
            x = randn(bb, n, c, std=3.0) + 0.5
            sc, bi = randn(c), randn(c)  # bf16, as the modules keep them
            xt = x.transpose(1, 2).contiguous()

            def lib(xt=xt, sc=sc, bi=bi, e=eps, a=act):
                y = F.group_norm(xt, 32, sc, bi, e)
                return F.silu(y) if a == "silu" else y

            cases.append(case(
                "fused_group_norm", f"({bb},{n},{c}) eps={eps} {act}",
                lambda x=x, sc=sc, bi=bi, e=eps, a=act: norms.fused_group_norm(x, sc, bi, 32, e, a),
                lambda x=x, sc=sc, bi=bi, e=eps, a=act: norms.group_norm_plain(x, sc, bi, 32, e, a),
                BF16_REL_TOL, (8 * bb * n * c, 2 * 2 * bb * n * c + 4 * c), lib, PEAK_FP32))
    for n, c in FF_KERNEL:
        cases.append(_ff_case(randn, case, b, n, c))
    for n, c in LN_UNET_B16:
        x = (randn(b, n, c, std=2.0) + 0.3).to(torch.bfloat16)
        sc, bi = randn(c), randn(c)  # bf16, as the modules keep them
        cases.append(case(
            "fused_layer_norm", f"({b},{n},{c}) eps=1e-05 bfloat16",
            lambda x=x, sc=sc, bi=bi: norms.fused_layer_norm(x, sc, bi, 1e-5),
            lambda x=x, sc=sc, bi=bi: norms.layer_norm_plain(x, sc, bi, 1e-5),
            BF16_REL_TOL, (8 * b * n * c, 2 * 2 * b * n * c + 4 * c),
            lambda x=x, sc=sc, bi=bi: F.layer_norm(x, (x.shape[-1],), sc, bi, 1e-5), PEAK_FP32))
    for cs in cases:
        cs["main"] = True
    return cases


def _bwd_main_cases(torch, dev, randn, case, heads):
    """dq and dk/dv (and their labeled forms) at the training batch B=4 and
    the step's five attention shapes, on the kernel forward's residuals;
    dk/dv takes delta from the dq kernel as the training backward does. The
    labeled fuser has META's labels on two rows and open labels on two.
    Library: SDPA's backward on the same views (`sdpa_bwd`: device time of
    forward + backward less the forward's), one number for the pair."""
    import torch.nn.functional as F

    from instancediffusion_tpu_torch.kernels import flash_attention as fa
    from instancediffusion_tpu_torch.ops.attention import labels_to_dense

    bits, open_ = meta_labels(torch, dev, 64)
    labels = (bits.repeat_interleave(TRAIN_B // 2, 0), open_.repeat_interleave(TRAIN_B // 2, 0))
    cases = []
    for label, n, m, c, labeled in TRAIN_ATTN:
        q, k, v, do = (heads(randn(TRAIN_B, s, 8 * c), c) for s in (n, m, m, n))
        lb = labels if labeled else None
        mask = labels_to_dense(*lb)[:, :, :n, :m] if labeled else None
        with torch.no_grad():
            out, lse = fa.flash_attention_fwd_lse(q, k, v, lb)
            delta = fa.flash_attention_bwd_dq(q, k, v, out, lse, do, lb, with_delta=True)[1]
        need = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def sdpa_fwd(need=need, mask=mask):
            return F.scaled_dot_product_attention(*need, attn_mask=mask)

        def sdpa_fwd_bwd(need=need, mask=mask, do=do):
            F.scaled_dot_product_attention(*need, attn_mask=mask).backward(do)

        res = (q, k, v, out, lse, do, lb)
        sfx = "_labeled" if labeled else ""
        for kind, kern, plain in (
                ("dq", lambda r=res: fa.flash_attention_bwd_dq(*r),
                 lambda r=res: fa.flash_attention_bwd_plain(*r)[0]),
                ("dkv", lambda r=res, d=delta: fa.flash_attention_bwd_dkv(*r, delta=d),
                 lambda r=res: fa.flash_attention_bwd_plain(*r)[1:])):
            cases.append(case(f"flash_attention_bwd_{kind}{sfx}", f"B={TRAIN_B} {label}", kern,
                              plain, GRAD_REL_TOL, _attn_work(kind, TRAIN_B, 8, n, m, c, mask),
                              None))
            cases[-1].update(sdpa_bwd=(f"B={TRAIN_B} {label}", sdpa_fwd, sdpa_fwd_bwd),
                             library_name="SDPA backward (fwd+bwd less fwd), both kernels")
    return cases


def _head_layout_cases(torch, randn, case):
    """K8 proj_split at the ds1 attention's shapes (8 heads of 40), at
    batch 2 and at the serving batch 16 (CFG over 8 images): q from the
    visual rows of the fuser's [x | objs] (a row slice), k and v over the
    self-attention's 4096 rows and over the fuser's unpadded 4280 (written
    padded to 4288, tail zeroed), and a ragged 333 rows (padded to 384, not
    a multiple of the kernel's 64-row tile); K8' merge_proj on
    the flash kernel's output layout and on a contiguous (B, H, N, c)
    tensor, with the fp32 bias. Library: F.linear of the same product
    without the relayout (one call over the concatenated k and v weights).
    The B=16 cases are main-path cases (device time)."""
    import torch.nn.functional as F

    from instancediffusion_tpu_torch.kernels import head_layout as hl

    cases = []
    w = lambda: randn(320, 320, std=320 ** -0.5)
    for b in (2, 16):
        first = len(cases)
        cat = randn(b, 4280, 320)
        for label, x, n_w in ((f"q ({b},4096,320) of a ({b},4280,320) row slice",
                               cat[:, :4096], 1),
                              (f"k,v ds1 self ({b},4096,320)", randn(b, 4096, 320), 2),
                              (f"k,v ds1 fuser ({b},4280,320) -> 4288", cat, 2),
                              (f"k,v ragged ({b},333,320) -> 384", randn(b, 333, 320), 2)):
            ws = [w() for _ in range(n_w)]
            wcat = torch.cat(ws)
            m = x.shape[1]
            mpad = -(-m // 64) * 64
            cases.append(case(
                "proj_split", label,
                lambda x=x, ws=ws: tuple(hl.proj_split(x, ws, 8)),
                lambda x=x, ws=ws: tuple(hl.proj_split_plain(x, ws, 8)),
                BF16_REL_TOL,
                (2 * b * m * 320 * 320 * n_w,
                 2 * (b * m * 320 + n_w * 320 * 320 + n_w * b * mpad * 320)),
                lambda x=x, wcat=wcat: F.linear(x, wcat)))
        o = randn(b, 4096, 8, 40).permute(0, 2, 1, 3)  # the flash kernel's output view
        wo, bo = w(), randn(320, std=0.1, dtype=torch.float32)
        for label, ov in ((f"({b},8,4096,40) flash output view -> ({b},4096,320) + bias", o),
                          (f"({b},8,4096,40) contiguous -> ({b},4096,320) + bias",
                           o.contiguous())):
            cases.append(case(
                "merge_proj", label,
                lambda o=ov, wo=wo, bo=bo: hl.merge_proj(o, wo, bo),
                lambda o=ov, wo=wo, bo=bo: hl.merge_proj_plain(o, wo, bo),
                BF16_REL_TOL,
                (2 * b * 4096 * 320 * 320, 2 * (2 * b * 4096 * 320 + 320 * 320) + 4 * 320),
                lambda o=ov, wo=wo, bo=bo, b=b: F.linear(
                    o.transpose(1, 2).reshape(b, 4096, 320), wo, bo.to(wo.dtype))))
        if b == FUSED_UNET_B:  # q, k/v self, k/v fuser, the flash output view
            for cs in cases[first:first + 3] + cases[first + 4:first + 5]:
                cs["main"] = True
    return cases


def _train_cases(torch, dev, randn, case, labels64):
    """The training kernels at the training step's attention shapes (batch
    2): K6 (out and lse), dq and dk/dv against their plain versions, on the
    residuals of the kernel forward. The library call for K6 is PyTorch's
    SDPA forward with inputs that need gradients (it then keeps its own
    statistics); dq and dk/dv have none of their own (SDPA's backward
    computes both: its time is printed beside K6's line)."""
    import torch.nn.functional as F

    from instancediffusion_tpu_torch.kernels import flash_attention as fa
    from instancediffusion_tpu_torch.ops.attention import labels_to_dense

    cases = []
    for label, n, m, c, labeled in TRAIN_ATTN:
        heads = lambda t, c=c: t.reshape(2, t.shape[1], 8, c).transpose(1, 2)
        q, k, v, do = (heads(randn(2, s, 8 * c)) for s in (n, m, m, n))
        labels = labels64 if labeled else None
        mask = labels_to_dense(*labels64)[:, :, :n, :m] if labeled else None
        with torch.no_grad():
            out, lse = fa.flash_attention_fwd_lse(q, k, v, labels)
        sfx = "_labeled" if labeled else ""
        need = [t.detach().requires_grad_(True) for t in (q, k, v)]

        def sdpa_fwd(need=need, mask=mask):
            return F.scaled_dot_product_attention(*need, attn_mask=mask)

        def sdpa_fwd_bwd(need=need, mask=mask, do=do):
            F.scaled_dot_product_attention(*need, attn_mask=mask).backward(do)

        cases.append(case(
            "flash_attention_trainable" + sfx, label,
            lambda q=q, k=k, v=v, lb=labels: fa.flash_attention_fwd_lse(q, k, v, lb),
            lambda q=q, k=k, v=v, lb=labels: fa.flash_attention_fwd_lse_plain(q, k, v, lb),
            BF16_REL_TOL, _attn_work("fwd_lse", 2, 8, n, m, c, mask), sdpa_fwd))
        cases[-1].update(sdpa_fwd_bwd=sdpa_fwd_bwd, lse_at=1)
        res = (q, k, v, out, lse, do, labels)
        cases.append(case(
            "flash_attention_bwd_dq" + sfx, label,
            lambda r=res: fa.flash_attention_bwd_dq(*r),
            lambda r=res: fa.flash_attention_bwd_plain(*r)[0],
            GRAD_REL_TOL, _attn_work("dq", 2, 8, n, m, c, mask), None))
        cases.append(case(
            "flash_attention_bwd_dkv" + sfx, label,
            lambda r=res: fa.flash_attention_bwd_dkv(*r),
            lambda r=res: fa.flash_attention_bwd_plain(*r)[1:],
            GRAD_REL_TOL, _attn_work("dkv", 2, 8, n, m, c, mask), None))
    return cases


def phase_kernels(torch, dev) -> dict:
    """Compare every kernel with its plain version and time it. Batch-2
    cases: the kernel, its plain version and the library call where there is
    one, each the median of 10 wrapper-timed calls (CUDA events). Main-path
    cases (`main`): the kernel's and the library call's device time over
    MAIN_REPS back-to-back launches, events around those launches, one
    wrapper-timed median. The JSON line reports each kernel's first batch-2
    case and its first main-path case."""
    from instancediffusion_tpu_torch.kernels import flash_attention as fa

    clock = max_sm_clock_hz()
    log(f"kernels: exp bound at {EX2_PER_CLOCK_SM} exp2/clock/SM x {SMS} SMs x "
        f"{clock / 1e6:.0f} MHz (nvidia-smi clocks.max.sm)")
    results = {}
    failures = []
    sdpa_bwd_ms = {}
    for cs in _cases(torch, dev):
        name, label, kern, plain, tol = (cs[k] for k in ("name", "label", "kern", "plain",
                                                          "tol"))
        main = cs.get("main", False)
        out = kern()
        ref = plain()
        torch.cuda.synchronize()
        err, rel, ok = _close(out, ref, tol, cs.get("lse_at"))
        del out, ref
        entry = results.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["max_rel_err"] = max(entry["max_rel_err"], rel)
        flops, nbytes, peak = cs["work"]
        bound_ms, bound_by = _bound(flops, nbytes, peak)
        exp_ms = None if cs["exps"] is None else _exp_bound(cs["exps"], clock)
        exp_txt = "" if exp_ms is None else f" exp_bound_ms={exp_ms:.4f}"
        verdict = f"max_abs_err={err:.4g} rel={rel:.3g} tol={tol:g} {'ok' if ok else 'FAIL'}"
        if main:
            dev_ms, ev_ms, wrap_ms = (device_ms(torch, kern), events_ms(torch, kern),
                                      median_ms(kern))
            lib_ms = None if cs["library"] is None else device_ms(torch, cs["library"])
            if "sdpa_bwd" in cs:  # derived once per shape, shared by dq and dk/dv
                key, fwd, fwd_bwd = cs["sdpa_bwd"]
                if key not in sdpa_bwd_ms:
                    sdpa_bwd_ms[key] = device_ms(torch, fwd_bwd) - device_ms(torch, fwd)
                lib_ms = sdpa_bwd_ms[key]
            if "main_device_ms" not in entry:
                entry.update(main_label=label, main_device_ms=dev_ms, main_library_ms=lib_ms,
                             main_bound_ms=bound_ms, main_bound_by=bound_by)
                if exp_ms is not None:
                    entry["main_exp_bound_ms"] = exp_ms
            extra = ""
            if name == "flash_attention" and entry["main_label"] == label:
                enc = []
                for _ in range(MAIN_REPS):
                    kern()
                    enc.append(fa.encode_us())
                extra = f" tensor_map_encode_us={sum(enc) / len(enc):.2f} (host, per call)"
            if name.startswith("flash_attention_bwd") and entry["main_label"] == label:
                kern()
                extra = f" tensor_map_encode_us={fa.bwd_encode_us():.2f} (host, one call)"
            ratio = "" if lib_ms is None else f" kernel/library={dev_ms / lib_ms:.3f}"
            lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
            if "library_name" in cs:
                extra += f" (library = {cs['library_name']})"
            log(f"kernels (main path): {name} {label}: {verdict} device_ms={dev_ms:.4f} "
                f"events_ms={ev_ms:.4f} wrapper_ms={wrap_ms:.4f} library_device_ms={lib}"
                f"{ratio} bound_ms={bound_ms:.4f} ({bound_by}) "
                f"bound_share={bound_ms / dev_ms:.3f}{exp_txt}{extra}")
        else:
            ms, plain_ms = median_ms(kern), median_ms(plain)
            lib_ms = None if cs["library"] is None else median_ms(cs["library"])
            if "ms" not in entry:
                entry.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                             bound_by=bound_by)
                if exp_ms is not None:
                    entry["exp_bound_ms"] = exp_ms
            extra = ""
            if "sdpa_fwd_bwd" in cs:
                fwd_bwd = median_ms(cs["sdpa_fwd_bwd"])
                extra = (f" sdpa_fwd_bwd_ms={fwd_bwd:.4f} sdpa_bwd_ms={fwd_bwd - lib_ms:.4f} "
                         "(derived: fwd_bwd - library)")
            lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
            if "library_name" in cs:
                extra += f" (library = {cs['library_name']})"
            log(f"kernels: {name} {label}: {verdict} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib} bound_ms={bound_ms:.4f} "
                f"({bound_by}){exp_txt} flops={flops:.4g} bytes={nbytes:.4g}{extra}")
        if not ok:
            failures.append(f"{name} {label}: rel err {rel:.3g} > {tol:g} (or lse > "
                            f"{LSE_ATOL})")
    if failures:
        raise RuntimeError("kernel checks failed:\n  " + "\n  ".join(failures))
    return results


def phase_routes(torch, dev) -> None:
    """What the switches by shape and dtype send where, checked on the card:
    the C=1280 feed-forwards at batch 2 and 16 (the unfused route, counted,
    no kernel launch, against the fp32 plain version, with the route's device
    time beside its bound); GroupNorm at the batch of `generate` at mis=0.36 with 30
    instances and 9 images (558 rows, above the resident blocks: several
    cooperative launches); a tiny fp32 `generate` (fp32 activations take the
    plain versions, LayerNorm's kernel keeps its fp32 rows) against
    `plain_kernels()`."""
    import numpy as np

    from instancediffusion_tpu_torch import kernels
    from instancediffusion_tpu_torch.config import load_config
    from instancediffusion_tpu_torch.kernels import geglu_ff as ff
    from instancediffusion_tpu_torch.kernels import norms
    from instancediffusion_tpu_torch.nn.core import plain_kernels
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    g = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    for b, n, c in ((bb, n, c) for bb in (2, FUSED_UNET_B) for n, c in FF_UNFUSED):
        args = _ff_args(randn, b * n, c)
        kernels.reset_launch_counts()
        out = ff.ff_geglu(*args)
        torch.cuda.synchronize()
        counts = (kernels.LAUNCHES.get("fused_ff_geglu", 0), kernels.ROUTES[FF_ROUTE])
        ref = ff.ff_geglu_plain(*args).float()
        rel = ((out.float() - ref).abs().max() / ref.abs().max()).item()
        # the route also rounds a, g and the first product to bf16
        if counts != (0, 1) or not rel <= 2 * BF16_REL_TOL:
            raise RuntimeError(f"routes: ff_geglu ({b},{n},{c}): (kernel, unfused) calls "
                               f"{counts}, rel err {rel:.3g}")
        bound_ms, bound_by = _bound(*_ff_work(b * n, c))
        log(f"routes: ff_geglu ({b},{n},{c}) inner={4 * c}: unfused by ff_fits, rel={rel:.3g} "
            f"tol={2 * BF16_REL_TOL:g} ok device_ms={device_ms(torch, lambda: ff.ff_geglu(*args)):.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by})")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for bb, n, c in ((558, 64, 1280), (558, 4096, 320)):
        x = randn(bb, n, c, std=3.0) + 0.5
        sc, bi = randn(c), randn(c)
        want = len(norms.gn_plan(bb, n, c, sms).launches(bb))
        kernels.reset_launch_counts()
        out = norms.fused_group_norm(x, sc, bi, 32, 1e-5, "silu")
        torch.cuda.synchronize()
        got = kernels.LAUNCHES.get("fused_group_norm", 0)
        err, rel, ok = _close(out, norms.group_norm_plain(x, sc, bi, 32, 1e-5, "silu"),
                              BF16_REL_TOL)
        if not ok or got != want or want < 2:
            raise RuntimeError(f"routes: fused_group_norm ({bb},{n},{c}): {got} launches "
                               f"(planned {want}), rel err {rel:.3g}")
        log(f"routes: fused_group_norm ({bb},{n},{c}) silu: {got} cooperative launches, "
            f"rel={rel:.3g} tol={BF16_REL_TOL:g} ok")
        del x, out
    gcfg = dict(in_dim=64, out_dim=64, mid_dim=64, fourier_freqs=4, fourier_freqs_polygons=4,
                n_scribble_points=4, n_polygon_points=8, seg_channels=4, seg_resize_input=64,
                convnext_depths=(1, 1), convnext_dims=(32, 64), convnext_feature_dim=4096)
    cfg = load_config(overrides=dict(
        model=dict(image_size=32, model_channels=64, num_heads=8, context_dim=64, max_objs=4,
                   grounding_tokenizer=gcfg, channel_mult=(1, 2), num_res_blocks=1,
                   attention_resolutions=(1, 2)),
        autoencoder=dict(ch=32, ch_mult=(1, 2), resolution=64),
        text_encoder=dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                          num_hidden_layers=1, num_attention_heads=4)))
    pipe = InstanceDiffusionPipeline.random_init(cfg, seed=0, device=dev, dtype=torch.float32)
    densify_(pipe.unet, 1)
    meta = {"prompt": "a cat and a dog", "phrases": ["a cat", "a dog"],
            "locations": [[0.1, 0.2, 0.5, 0.9], [0.5, 0.3, 0.9, 0.9]]}
    kernels.reset_launch_counts()
    imgs = pipe.generate(meta, num_images=2, steps=4, mis=0.0, seed=0)
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    with plain_kernels():
        ref = pipe.generate(meta, num_images=2, steps=4, mis=0.0, seed=0)
    diff = int(np.abs(imgs.astype(int) - ref.astype(int)).max())
    if set(launched) != {"fused_layer_norm"} or diff > 1 or int(imgs.max()) == int(imgs.min()):
        raise RuntimeError(f"routes: tiny fp32 generate launched {launched}, max uint8 diff "
                           f"{diff} against plain_kernels()")
    log(f"routes: tiny fp32 generate (2 images, 4 steps): launches {launched}, "
        f"max uint8 diff {diff} against plain_kernels() (limit 1)")


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


_GATE_NAMES = ("alpha_attn", "alpha_dense", "scaleu")


def densify_(module, seed: int) -> None:
    """Redraw every parameter from a seeded normal, so no part of the
    network is zero at random init (zero-initialised output convs, fuser
    gates tanh(0)=0 and ScaleU's identity would hide it): weights
    N(0, 1/fan_in), norm scales 1 + N(0, 0.1), fuser gates and ScaleU
    N(0, 0.5), everything else N(0, 0.1)."""
    import torch

    names = sorted(n for n, _ in module.named_parameters())
    params = dict(module.named_parameters())
    dev = next(iter(params.values())).device
    g = torch.Generator(device=dev).manual_seed(seed)
    for name in names:
        p = params[name]
        z = torch.randn(p.shape, generator=g, device=dev)
        if any(k in name for k in _GATE_NAMES):
            v = 0.5 * z
        elif name.endswith("weight") and p.dim() >= 2:
            v = z / math.sqrt(p[0].numel())
        elif name.endswith("weight"):
            v = 1.0 + 0.1 * z
        else:
            v = 0.1 * z
        p.data.copy_(v.to(p.dtype))


# ---------------------------------------------------------------------------
# UNet forward: kernels vs plain
# ---------------------------------------------------------------------------


def phase_grounding(torch, dev, cfg, unet_mod):
    """UniFusion on the slice's layout with random phrase embeddings and
    random instance masks, in fp32 as in generate, kernels vs
    plain_kernels(). The seg tokens are kept (the box preset drops them,
    which would multiply the ConvNeXt's features by zero), so the fp32
    LayerNorm kernel's output reaches the tokens. Returns the line and the
    kernel path's (1, 184, 768) fp32 grounding tokens."""
    import dataclasses

    from instancediffusion_tpu_torch import kernels
    from instancediffusion_tpu_torch.data.grounding_input import (
        DEFER_EMBEDDING, prepare_grounding,
    )
    from instancediffusion_tpu_torch.models import unifusion
    from instancediffusion_tpu_torch.nn.core import plain_kernels

    mc = cfg.model
    gcfg = mc.grounding_tokenizer
    k = len(META["phrases"])
    g_np = prepare_grounding(META, [DEFER_EMBEDDING] * k, batch=1, max_objs=mc.max_objs,
                             in_dim=gcfg.in_dim, n_scribble_points=gcfg.n_scribble_points,
                             n_polygon_points=gcfg.n_polygon_points,
                             seg_size=gcfg.seg_resize_input)
    g = {key: torch.from_numpy(v).to(dev, torch.float32) for key, v in g_np.items()}
    gen = torch.Generator(device=dev).manual_seed(4)
    g["positive_embeddings"][0, :k] = torch.randn((k, gcfg.in_dim), generator=gen, device=dev)
    s = gcfg.seg_resize_input
    g["segs"][0, :k] = (torch.rand((k, s, s), generator=gen, device=dev) < 0.5).float()
    drops = dataclasses.replace(unifusion.ModalityDrops.test_defaults(gcfg), drop_segs=False)
    with torch.inference_mode():
        kernels.reset_launch_counts()
        objs_k = unifusion.apply_unifusion(unet_mod.position_net, gcfg, g, drops)
        torch.cuda.synchronize()
        ln_launches = kernels.LAUNCHES.get("fused_layer_norm", 0)
        with plain_kernels():
            objs_p = unifusion.apply_unifusion(unet_mod.position_net, gcfg, g, drops)
    n_tok = unifusion.num_grounding_tokens(gcfg, mc.max_objs)
    if (objs_k.shape != (1, n_tok, gcfg.out_dim) or objs_k.dtype != torch.float32
            or not torch.isfinite(objs_k).all()):
        raise RuntimeError(f"grounding: bad tokens {tuple(objs_k.shape)} {objs_k.dtype}")
    if ln_launches <= 0:
        raise RuntimeError("grounding: the LayerNorm kernel never launched")
    err = (objs_k - objs_p).abs().max().item()
    scale = objs_p.abs().max().item()
    rel = err / max(scale, 1e-12)
    if scale == 0.0 or rel > GROUNDING_REL_TOL:
        raise RuntimeError(f"grounding: kernels vs plain rel err {rel:.3g} > "
                           f"{GROUNDING_REL_TOL}")
    line = (f"grounding: UniFusion fp32 (segs kept) tokens={n_tok} "
            f"LayerNorm launches={ln_launches} "
            f"max_abs_err={err:.4g} max|tok|={scale:.4g} rel={rel:.3g} "
            f"tol={GROUNDING_REL_TOL}")
    return line, objs_k


def phase_unet(torch, dev, cfg, unet_mod, objs1, masked: bool) -> str:
    """objs1: the (1, G, 768) fp32 grounding tokens of the grounding phase.
    masked: the ds1 fusers take META's box labels (sample 0 masked, sample
    1 open) and the labeled kernel must launch."""
    from instancediffusion_tpu_torch import kernels
    from instancediffusion_tpu_torch.models import unet as unet_lib
    from instancediffusion_tpu_torch.nn.core import plain_kernels

    g = torch.Generator(device=dev).manual_seed(1)
    mc = cfg.model
    x = torch.randn((2, mc.image_size, mc.image_size, mc.in_channels),
                    generator=g, device=dev).to(torch.bfloat16)
    t = torch.tensor([981, 981], device=dev)
    ctx = torch.randn((2, 77, mc.context_dim), generator=g, device=dev).to(torch.bfloat16)
    objs = objs1.expand(2, *objs1.shape[1:])
    n_tok = objs.shape[1]
    labels = meta_labels(torch, dev, mc.image_size) if masked else None
    with torch.inference_mode():
        run = lambda: unet_lib.apply_unet(unet_mod, mc, x, t, ctx, None, gate_scale=1.0,
                                          precomputed_objs=objs, fuser_mask=labels)
        kernels.reset_launch_counts()
        eps_k = run()
        labeled = kernels.LAUNCHES.get("flash_attention_labeled", 0)
        with plain_kernels():
            eps_p = run()
        torch.cuda.synchronize()
        ms_k = median_ms(run, reps=5)
        with plain_kernels():
            ms_p = median_ms(run, reps=5)
    if eps_k.shape != x.shape or not torch.isfinite(eps_k.float()).all():
        raise RuntimeError(f"unet: bad eps {tuple(eps_k.shape)}")
    if masked != (labeled > 0):
        raise RuntimeError(f"unet: masked={masked} but {labeled} labeled launches")
    err = (eps_k.float() - eps_p.float()).abs().max().item()
    scale = eps_p.float().abs().max().item()
    rel = err / max(scale, 1e-12)
    if scale == 0.0 or rel > UNET_REL_TOL:
        raise RuntimeError(f"unet: kernels vs plain rel err {rel:.3g} "
                           f"(max |eps| {scale:.3g}) > {UNET_REL_TOL}")
    return (f"unet: B=2 gate=1.0 tokens={n_tok} "
            f"{f'ds1 fusers masked ({labeled} labeled launches) ' if masked else ''}"
            f"max_abs_err={err:.4g} "
            f"max|eps|={scale:.4g} rel={rel:.3g} tol={UNET_REL_TOL} "
            f"kernel_fwd_ms={ms_k:.2f} plain_fwd_ms={ms_p:.2f}")


# ---------------------------------------------------------------------------
# slice
# ---------------------------------------------------------------------------


def phase_request(torch, pipe, card: str, name: str, meta: dict, mis: float,
                  must_launch: tuple) -> tuple[str, dict]:
    """generate(8 images, 50 steps, `mis`): one warm-up request, then two
    timed requests with the launch counts set to 0 just before them; checks
    the images and that every kernel of `must_launch` launched."""
    import numpy as np

    from instancediffusion_tpu_torch import kernels

    n_img = N_IMAGES
    t0 = time.perf_counter()
    imgs = pipe.generate(meta, num_images=n_img, steps=STEPS, mis=mis, seed=0)
    warm_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    times = []
    for seed in (1, 2):
        t0 = time.perf_counter()
        imgs = pipe.generate(meta, num_images=n_img, steps=STEPS, mis=mis, seed=seed)
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    ff_calls = {"fused_ff_geglu": launches.get("fused_ff_geglu", 0) / len(times),
                FF_ROUTE: kernels.ROUTES[FF_ROUTE] / len(times)}
    if mis == 0.0 and ff_calls != FF_PER_REQUEST:
        raise RuntimeError(f"{name}: feed-forward calls per request {ff_calls} (expected "
                           f"{FF_PER_REQUEST})")
    size = pipe.image_size
    if imgs.shape != (n_img, size, size, 3) or imgs.dtype != np.uint8:
        raise RuntimeError(f"{name}: images {imgs.shape} {imgs.dtype}")
    if int(imgs.max()) == int(imgs.min()):
        raise RuntimeError(f"{name}: constant images")
    missing = [k for k in must_launch if launches.get(k, 0) <= 0]
    if missing:
        raise RuntimeError(f"{name}: kernels never launched: {missing} ({launches})")
    s_img = min(times) / n_img
    line = (f"{name}: generate B={n_img} steps={STEPS} PLMS mis={mis} bf16 "
            f"masked={pipe.cfg.model.use_masked_att}: warm-up {warm_s:.2f}s, requests "
            f"{', '.join(f'{t:.3f}s' for t in times)}, {s_img:.4f} s/image on {card}; "
            f"feed-forward calls per request {ff_calls}; launches {launches}")
    return line, launches


def phase_fused_unet(torch, dev, cfg, unet_mod, objs1) -> str:
    """The B=16 gate-1 forward with FUSED_PROJ on against off, both on the
    kernels (error relative to max |eps|, both times on the host clock and
    by device time, off, on, on, off; the fused run's head-layout
    launches)."""
    from instancediffusion_tpu_torch import kernels
    from instancediffusion_tpu_torch.models import unet as unet_lib

    g = torch.Generator(device=dev).manual_seed(5)
    mc = cfg.model
    b = FUSED_UNET_B
    x = torch.randn((b, mc.image_size, mc.image_size, mc.in_channels), generator=g,
                    device=dev).to(torch.bfloat16)
    t = torch.full((b,), 981, device=dev)
    ctx = torch.randn((b, 77, mc.context_dim), generator=g, device=dev).to(torch.bfloat16)
    objs = objs1.expand(b, *objs1.shape[1:])
    run = lambda: unet_lib.apply_unet(unet_mod, mc, x, t, ctx, None, gate_scale=1.0,
                                      precomputed_objs=objs)
    with torch.inference_mode():
        eps_u = run()
        ms_u = median_ms(run, reps=5)
        unet_lib.FUSED_PROJ = True
        try:
            kernels.reset_launch_counts()
            eps_f = run()
            torch.cuda.synchronize()
            launches = {k: kernels.LAUNCHES.get(k, 0) for k in
                        ("proj_split", "merge_proj", "flash_attention")}
            ms_f = median_ms(run, reps=5)
            dev_ms = {}
            for fused in (False, True, True, False):
                unet_lib.FUSED_PROJ = fused
                dev_ms.setdefault(fused, []).append(device_ms(torch, run, reps=3))
        finally:
            unet_lib.FUSED_PROJ = False
    if launches != {"proj_split": 2 * DS1_ATTENTIONS, "merge_proj": DS1_ATTENTIONS,
                    "flash_attention": DS1_ATTENTIONS}:
        raise RuntimeError(f"fused: launches per forward {launches}")
    if not torch.isfinite(eps_f.float()).all():
        raise RuntimeError("fused: non-finite eps")
    err = (eps_f.float() - eps_u.float()).abs().max().item()
    scale = eps_u.float().abs().max().item()
    rel = err / max(scale, 1e-12)
    if scale == 0.0 or rel > UNET_REL_TOL:
        raise RuntimeError(f"fused: FUSED_PROJ on vs off rel err {rel:.3g} > {UNET_REL_TOL}")
    return (f"fused: B={b} gate=1.0 FUSED_PROJ on vs off (both kernels): max_abs_err={err:.4g} "
            f"max|eps|={scale:.4g} rel={rel:.3g} tol={UNET_REL_TOL}; fused_fwd_ms={ms_f:.2f} "
            f"unfused_fwd_ms={ms_u:.2f}; device_ms fused "
            f"{' / '.join(f'{v:.3f}' for v in dev_ms[True])} unfused "
            f"{' / '.join(f'{v:.3f}' for v in dev_ms[False])}; "
            f"launches per fused forward {launches}")


def _png_size(data: bytes) -> tuple[int, int]:
    """(width, height) of an 8-bit RGB PNG after checking its signature and
    that its image data inflate to height rows of 1 + 3 * width bytes."""
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n" or data[12:16] != b"IHDR":
        raise RuntimeError("serve: reply is not a PNG")
    w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24], "big")
    pos, idat = 8, b""
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    if len(zlib.decompress(idat)) != h * (1 + 3 * w):
        raise RuntimeError("serve: PNG image data of the wrong size")
    return w, h


def _post_all(port: int, seeds) -> list[tuple[float, bytes]]:
    """POST META with each seed at once (one thread each); (seconds, body)
    per request, each a 200 image/png reply."""
    import concurrent.futures
    import urllib.request

    def one(seed):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                     data=json.dumps(dict(META, seed=seed)).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            if r.status != 200 or r.headers["Content-Type"] != "image/png":
                raise RuntimeError(f"serve: reply {r.status} {r.headers['Content-Type']}")
            body = r.read()
        return time.perf_counter() - t0, body

    with concurrent.futures.ThreadPoolExecutor(len(seeds)) as ex:
        return list(ex.map(one, seeds))


def phase_serve(torch, pipe, card: str, fused: bool) -> tuple[str, dict]:
    """serve(port=0, DPM 20 steps, batch 8, mis=0) with FUSED_PROJ `fused`:
    warm-up (one batch, before the port opens), 2 x 8 concurrent POSTs,
    then a burst of 16. Checks every PNG (512x512) and the launches per
    batch; returns the line and the launches of the timed requests."""
    from instancediffusion_tpu_torch import kernels, serve
    from instancediffusion_tpu_torch.models import unet as unet_lib

    name = "serve" if fused else "serve_unfused"
    unet_lib.FUSED_PROJ = fused
    try:
        t0 = time.perf_counter()
        server = serve.serve(pipe, port=0, batch_size=SERVE_B, max_wait_ms=50.0,
                             steps=SERVE_STEPS, sampler="dpm", mis=0.0)
        warm_s = time.perf_counter() - t0
        try:
            port = server.server_address[1]
            b0 = server.batcher.batches
            kernels.reset_launch_counts()
            rounds = []
            for seeds in (range(8), range(100, 108), range(200, 216)):
                t0 = time.perf_counter()
                replies = _post_all(port, list(seeds))
                rounds.append((time.perf_counter() - t0, replies))
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            routed = kernels.ROUTES[FF_ROUTE]
            batches = server.batcher.batches - b0
            batch_s = list(server.batcher.batch_seconds)[-batches:]
            phases = ", ".join(f"{k} {v:.3f}s" for k, v in pipe.last_timings.items())
        finally:
            server.shutdown()
            server.server_close()
            server.batcher.close()
    finally:
        unet_lib.FUSED_PROJ = False
    size = pipe.image_size
    lat = sorted(s for _, replies in rounds for s, _ in replies)
    bodies = [body for _, replies in rounds for _, body in replies]
    if any(_png_size(b) != (size, size) for b in bodies) or len(set(bodies)) < 2:
        raise RuntimeError(f"{name}: replies are not distinct {size}x{size} PNGs")
    per = {k: launches.get(k, 0) / batches for k in (*SERVE_LAUNCHES, "fused_ff_geglu")}
    per[FF_ROUTE] = routed / batches
    want = SERVE_LAUNCHES if fused else dict(SERVE_LAUNCHES, proj_split=0, merge_proj=0)
    want = dict(want, **FF_PER_BATCH)
    missing = [k for k in (SERVE_PATH if fused else PLAIN_PATH) if launches.get(k, 0) <= 0]
    if per != want or missing:
        raise RuntimeError(f"{name}: {batches} batches, launches per batch {per} (expected "
                           f"{want}), never launched {missing}")
    n_img = len(bodies)
    total_s = sum(s for s, _ in rounds)
    line = (f"{name}: DPM-{SERVE_STEPS} batch {SERVE_B} FUSED_PROJ={fused}: warm-up "
            f"{warm_s:.2f}s; rounds of 8, 8, 16 concurrent POSTs in "
            f"{', '.join(f'{s:.3f}s' for s, _ in rounds)} ({n_img / total_s:.3f} img/s overall, "
            f"burst {16 / rounds[2][0]:.3f} img/s); latency p50 {lat[len(lat) // 2]:.3f}s "
            f"max {lat[-1]:.3f}s; {batches} batches, s/batch "
            f"{', '.join(f'{s:.3f}' for s in batch_s)} (last batch: {phases}); "
            f"{n_img} PNGs {size}x{size} "
            f"on {card}; launches per batch {per}; launches {launches}")
    return line, launches


def phase_ddim_img2img(torch, pipe, card: str) -> tuple[str, dict, dict]:
    """generate with DDIM (20 steps, B=8), then img2img of its first image
    (strength 0.5, 50 steps: 25 PLMS steps, B=8); two requests each, the
    launches of the second."""
    import numpy as np

    from instancediffusion_tpu_torch import kernels

    size = pipe.image_size
    out = {}
    for name, call in (
            ("ddim", lambda s: pipe.generate(META, num_images=N_IMAGES, steps=20,
                                             sampler="ddim", seed=s)),
            ("img2img", lambda s: pipe.img2img(out["ddim"][2][0], META, strength=0.5,
                                               num_images=N_IMAGES, steps=STEPS, seed=s))):
        times = []
        for seed in (1, 2):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            imgs = call(seed)
            times.append(time.perf_counter() - t0)
        if imgs.shape != (N_IMAGES, size, size, 3) or imgs.dtype != np.uint8 \
                or int(imgs.max()) == int(imgs.min()):
            raise RuntimeError(f"{name}: images {imgs.shape} {imgs.dtype}")
        launches = dict(kernels.LAUNCHES)
        missing = [k for k in PLAIN_PATH if launches.get(k, 0) <= 0]
        if missing:
            raise RuntimeError(f"{name}: kernels never launched: {missing}")
        out[name] = (times, launches, imgs)
    (t_d, l_d, _), (t_i, l_i, _) = out["ddim"], out["img2img"]
    line = (f"ddim: generate B={N_IMAGES} DDIM-20 requests {t_d[0]:.3f}s, {t_d[1]:.3f}s "
            f"({min(t_d) / N_IMAGES:.4f} s/image); img2img B={N_IMAGES} strength 0.5 of "
            f"{STEPS} PLMS steps requests {t_i[0]:.3f}s, {t_i[1]:.3f}s "
            f"({min(t_i) / N_IMAGES:.4f} s/image) on {card}; launches ddim {l_d}, "
            f"img2img {l_i}")
    return line, l_d, l_i


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def train_batch(torch, dev, cfg, b: int) -> dict:
    """The synthetic training batch bench.py builds (numpy seed 0): 512 px
    images, 30 objects with random boxes, points, scribbles, polygons and
    phrase embeddings, every object live, no instance masks."""
    import numpy as np

    rng = np.random.default_rng(0)
    g = cfg.model.grounding_tokenizer
    n = cfg.model.max_objs
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    image = f32(rng.standard_normal((b, TRAIN_IMAGE, TRAIN_IMAGE, 3)))
    ids = torch.as_tensor(rng.integers(0, 49408, (b, 77)).astype(np.int32), device=dev)
    boxes = f32(rng.uniform(0, 1, (b, n, 4)))
    emb = f32(rng.standard_normal((b, n, 768)))
    points = f32(rng.uniform(0, 1, (b, n, 2)))
    scribbles = f32(rng.uniform(0, 1, (b, n, g.n_scribble_points * 2)))
    polygons = f32(rng.uniform(0, 1, (b, n, g.n_polygon_points * 2)))
    ones = torch.ones((b, n), device=dev)
    return {"image": image, "caption_ids": ids, "boxes": boxes, "masks": ones,
            "text_masks": ones, "text_embeddings": emb, "points": points,
            "scribbles": scribbles, "polygons": polygons,
            "segs": torch.zeros((b, n, g.seg_resize_input, g.seg_resize_input), device=dev)}


def _param_group(cfg):
    """name -> parameter group: "fuser_ds<k>" by the resolution of the
    spatial transformer holding the fuser, "position_net", "scaleu"."""
    from instancediffusion_tpu_torch.models.unet import build_plan

    inp, mid, out = build_plan(cfg.model)
    ds_of = {}
    for part, plan in (("input_blocks", inp), ("output_blocks", out)):
        for i, specs in enumerate(plan):
            for j, spec in enumerate(specs):
                if spec.kind == "attn":
                    ds_of[f"{part}.{i}.{j}."] = spec.ds
    for j, spec in enumerate(mid):
        if spec.kind == "attn":
            ds_of[f"middle_block.{j}."] = spec.ds

    def group(name: str) -> str:
        if ".fuser." in name:
            return "fuser_ds%d" % next(d for p, d in ds_of.items() if name.startswith(p))
        return name.split(".")[0]

    return group


def _per_step(launches: dict, names, steps: int) -> dict:
    return {k: launches.get(k, 0) / steps for k in names}


def phase_train(torch, dev, card: str) -> tuple[dict, dict]:
    """(launches of the timed steps, launches of the masked steps)."""
    import contextlib

    from instancediffusion_tpu_torch import kernels
    from instancediffusion_tpu_torch.config import Config, apply_test_preset
    from instancediffusion_tpu_torch.models import unifusion
    from instancediffusion_tpu_torch.nn.core import plain_kernels
    from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
    from instancediffusion_tpu_torch.train import optimizer as popt
    from instancediffusion_tpu_torch.train import train_step as pts

    cfg = Config()
    tc, dc = cfg.train, cfg.diffusion
    t0 = time.perf_counter()
    state = pts.init_train_state(cfg, seed=0, device=dev)
    densify_(state.unet, 11)
    densify_(state.vae, 12)
    densify_(state.clip, 13)
    state.ema = popt.init_ema(state.unet)
    state.optimizer, state.scheduler = popt.make_optimizer(
        state.unet, tc.base_learning_rate, tc.weight_decay, tc.warmup_steps, tc.scheduler_type,
        tc.total_iters)
    state = pts.cast_frozen_bf16(state)
    diffusion = make_diffusion_schedule(dc.beta_schedule, dc.timesteps, dc.linear_start,
                                        dc.linear_end)
    batch = train_batch(torch, dev, cfg, TRAIN_B)
    latent = pts.latent_shape(cfg, TRAIN_IMAGE)
    gen = torch.Generator(device=dev).manual_seed(0)
    trainable = popt.trainable_parameters(state.unet)
    torch.cuda.synchronize()
    log(f"train: init (fp32 random init, densify, AdamW, frozen -> bf16) "
        f"{time.perf_counter() - t0:.1f}s; trainable parameters "
        f"{popt.count_trainable(state.unet)}")

    # (a) one step's loss and gradients, kernels vs plain_kernels(), on
    # draws that drop nothing (every group then takes part)
    loss_fn = pts.make_loss_fn(cfg, diffusion)
    draws = pts.sample_draws(gen, TRAIN_B, latent)
    draws.drop_all, draws.drops = False, unifusion.ModalityDrops()

    def loss_and_grads(plain: bool):
        with plain_kernels() if plain else contextlib.nullcontext():
            loss = loss_fn(state, batch, draws)
            loss.backward()
        grads = {n: p.grad for n, p in trainable.items()}
        for p in trainable.values():
            p.grad = None
        return loss.item(), grads

    loss_k, g_k = loss_and_grads(False)
    # (b) liveness of the kernel path's gradients
    frozen = [n for n, p in state.unet.named_parameters()
              if not popt.is_trainable(n) and p.grad is not None]
    bad = [n for n, g in g_k.items() if g is None or not bool(torch.isfinite(g).all())]
    if frozen or bad:
        raise RuntimeError(f"train: frozen parameters with gradients {frozen[:5]}, "
                           f"trainable ones without finite gradients {bad[:5]}")
    loss_p, g_p = loss_and_grads(True)
    group = _param_group(cfg)
    sums: dict = {}
    for n in g_k:
        d = sums.setdefault(group(n), [0.0, 0.0, 0.0])
        d[0] += (g_k[n].float() - g_p[n].float()).pow(2).sum().item()
        d[1] += g_p[n].float().pow(2).sum().item()
        d[2] += g_k[n].float().pow(2).sum().item()
    del g_k, g_p
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    rels = {k: math.sqrt(d[0] / d[1]) if d[1] > 0 else float("inf") for k, d in sums.items()}
    want = {group(n) for n in trainable}  # Config(): fusers at ds1/2/4/8, position_net, scaleu
    dead = sorted(k for k, d in sums.items() if not d[2] > 0)
    log(f"train (a): B={TRAIN_B} loss kernels={loss_k:.6f} plain={loss_p:.6f} "
        f"rel={loss_rel:.3g} tol={TRAIN_LOSS_REL_TOL}; gradient rel err by group "
        + ", ".join(f"{k}={v:.3g}" for k, v in sorted(rels.items()))
        + f" tol={TRAIN_GRAD_REL_TOL}")
    log("train (b): every trainable gradient finite, no frozen gradient; "
        "group gradient norms "
        + ", ".join(f"{k}={math.sqrt(d[2]):.4g}" for k, d in sorted(sums.items())))
    if set(sums) != want or dead:
        raise RuntimeError(f"train: groups {sorted(sums)} (want {sorted(want)}), zero "
                           f"gradient in {dead}")
    if not loss_rel <= TRAIN_LOSS_REL_TOL or any(not v <= TRAIN_GRAD_REL_TOL
                                                 for v in rels.values()):
        raise RuntimeError(f"train: kernels vs plain loss rel {loss_rel:.3g}, gradients "
                           f"{rels}")

    # (c) 2 warm-up steps, then TRAIN_STEPS timed ones (draws made first)
    step = pts.make_train_step(cfg, diffusion)
    for _ in range(2):
        state, m = step(state, batch, pts.sample_draws(gen, TRAIN_B, latent))
    timed = [pts.sample_draws(gen, TRAIN_B, latent) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # state, batch, draws and anything earlier left
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = [step(state, batch, d)[1] for d in timed]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    routed = kernels.ROUTES[FF_ROUTE] / TRAIN_STEPS
    peak = torch.cuda.max_memory_allocated()
    per = _per_step(launches, TRAIN_PATH, TRAIN_STEPS)
    losses = [float(m["loss"]) for m in metrics]
    loss_list = ", ".join("%.4f" % x for x in losses)
    if any(m["skipped"] for m in metrics) or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"train: non-finite losses {losses}")
    want = dict(TRAIN_LAUNCHES, fused_ff_geglu=FF_PER_STEP["fused_ff_geglu"])
    wrong = {k: per[k] for k, n in want.items() if per[k] != n}
    missing = [k for k in TRAIN_PATH if per[k] <= 0]
    if wrong or missing or routed != FF_PER_STEP[FF_ROUTE]:
        raise RuntimeError(f"train: launches per step {per}, unfused feed-forwards {routed} "
                           f"(expected {want}, {FF_PER_STEP[FF_ROUTE]})")
    log(f"train (c): B={TRAIN_B} {TRAIN_IMAGE}px remat bf16, {TRAIN_STEPS} steps in {secs:.3f}s: "
        f"{secs / TRAIN_STEPS:.4f} s/step, {TRAIN_B * TRAIN_STEPS / secs:.3f} samples/s, "
        f"max_memory_allocated {peak / 2**30:.2f} GiB ({held / 2**30:.2f} allocated before "
        f"the steps) on {card}; losses "
        f"{loss_list}; launches per step {per}, unfused feed-forwards per step {routed}")

    # (d) masked training: the "mask" preset with use_masked_att
    mcfg = apply_test_preset(Config(), "mask")
    mcfg = dataclasses.replace(mcfg, model=dataclasses.replace(mcfg.model, use_masked_att=True))
    mstep = pts.make_train_step(mcfg, diffusion)
    mdraws = [pts.sample_draws(gen, TRAIN_B, latent) for _ in range(3)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    mmetrics = [mstep(state, batch, d)[1] for d in mdraws]
    torch.cuda.synchronize()
    msecs = time.perf_counter() - t0
    mlaunches = dict(kernels.LAUNCHES)
    mper = _per_step(mlaunches, MASKED_TRAIN_PATH, 3)
    if any(m["skipped"] for m in mmetrics) or mper != MASKED_LAUNCHES:
        raise RuntimeError(f"train (d): skipped {[m['skipped'] for m in mmetrics]}, "
                           f"launches per step {mper} (expected {MASKED_LAUNCHES})")
    loss = pts.make_loss_fn(mcfg, diffusion)(state, batch, mdraws[-1])
    loss.backward()
    bad = [n for n, p in trainable.items() if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    state.optimizer.zero_grad(set_to_none=True)
    if bad:
        raise RuntimeError(f"train (d): non-finite or missing gradients {bad[:5]}")
    mlosses = ", ".join("%.4f" % float(m["loss"]) for m in mmetrics)
    log(f"train (d): mask preset use_masked_att, 3 steps in {msecs:.3f}s "
        f"({msecs / 3:.4f} s/step), losses {mlosses}, gradients finite; "
        f"launches per step {mper}")
    return launches, mlaunches


def main() -> int:
    import torch

    # the port itself (in a directory without it, this fails before any output)
    from instancediffusion_tpu_torch.config import Config, apply_test_preset
    from instancediffusion_tpu_torch.kernels import _build
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    # device
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"allow_tf32 matmul=False cudnn=False)")

    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f}s ({_build.BUILD_INFO.get('path')})")

    results = phase_kernels(torch, dev)

    os.environ.setdefault("IDTPU_ALLOW_HASH_TOKENIZER", "1")
    phase_routes(torch, dev)
    cfg = apply_test_preset(Config(), "box")
    t0 = time.perf_counter()
    pipe = InstanceDiffusionPipeline.random_init(cfg, seed=0, device=dev, vae_encoder=True)
    densify_(pipe.unet, 1)
    densify_(pipe.vae, 2)
    densify_(pipe.clip, 3)
    torch.cuda.synchronize()
    log(f"init: random_init + densify {time.perf_counter() - t0:.1f}s")
    line, objs = phase_grounding(torch, dev, cfg, pipe.unet)
    log(line)
    log(phase_unet(torch, dev, cfg, pipe.unet, objs, masked=False))
    log(phase_unet(torch, dev, cfg, pipe.unet, objs, masked=True))
    log(phase_fused_unet(torch, dev, cfg, pipe.unet, objs))
    line, launches_plain = phase_request(torch, pipe, card, "slice", META, 0.0, PLAIN_PATH)
    log(line)

    # the paper's default sampling: MIS (mis=0.36) with the fusers masked by
    # instance labels, on the same weights, with instance masks as segs
    mcfg = apply_test_preset(Config(), "mask")
    mcfg = dataclasses.replace(mcfg, model=dataclasses.replace(mcfg.model, use_masked_att=True))
    mpipe = InstanceDiffusionPipeline(mcfg, pipe.unet, pipe.vae, pipe.clip, pipe.tokenizer)
    line, launches_mis = phase_request(torch, mpipe, card, "mis", dict(META, segs=meta_segs()),
                                       0.36, MIS_PATH)
    log(line)

    # the serving path (generate_batch, DPM-20, batch 8) on the FUSED_PROJ
    # route and off it; DDIM and img2img requests
    line, launches_serve = phase_serve(torch, pipe, card, fused=True)
    log(line)
    line, launches_serve_unfused = phase_serve(torch, pipe, card, fused=False)
    log(line)
    line, launches_ddim, launches_i2i = phase_ddim_img2img(torch, pipe, card)
    log(line)
    del pipe, mpipe
    torch.cuda.empty_cache()

    # the training step at full width, unmasked then masked
    launches_train, launches_masked = phase_train(torch, dev, card)

    kernels_json = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        by_path = {"slice": launches_plain.get(name, 0), "mis": launches_mis.get(name, 0),
                   "serve": launches_serve.get(name, 0),
                   "serve_unfused": launches_serve_unfused.get(name, 0),
                   "ddim": launches_ddim.get(name, 0), "img2img": launches_i2i.get(name, 0),
                   "train": launches_train.get(name, 0),
                   "train_masked": launches_masked.get(name, 0)}
        entry = {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        }
        entry.update({k: r[k] for k in ("exp_bound_ms", "main_label", "main_device_ms",
                                        "main_library_ms", "main_bound_ms", "main_bound_by",
                                        "main_exp_bound_ms") if k in r})
        if name in ONLY_KERNELS_PHASE:
            entry["checked"] = ONLY_KERNELS_PHASE[name]
        kernels_json.append(entry)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels_json}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
