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
             the library call's device time and the share of the bound;
             and K2, K3, K4, K5 at the SDXL refiner's B=16 shapes (12 heads
             of 64, GroupNorm up to 3072 channels, C=768 feed-forward)
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
  refiner    the SDXL-Refiner cascade at its published widths (2.3 B UNet,
             OpenCLIP-bigG, SD VAE at 0.13025) on densified random weights:
             a B=2 forward at 512 px, kernels vs plain_kernels(); the B=16
             forward's time; `refine` of 8 images at 512 px and of one at
             1024 px (20 DDIM steps at strength 0.35: 7 kept, CFG as one 2B
             forward), a warm-up then a timed call each: s/refine, stages,
             peak memory, launches held to the counts the refiner's plan
             gives (K2 140, K5 140 at 512 px)
  cli        the demo CLI from checkpoint files: the smoke's bf16 weights
             written as a flat SD-form checkpoint (`io/checkpoint.reference_state_dict`,
             the stock first conv in pretrained/) and a kohya LoRA on the ds1
             attentions, then `inference.main` in-process on
             demos/demo_fox_meadow.json --use_masks (8 images, 50 steps, mask
             preset, mis 0.36), without and with --lora (that run also with
             --cascade_strength 0.35: 8 refined PNGs, the refine's K2 / K5
             launches as its plan gives): loaded weights
             bit-equal to the in-memory ones, PNGs within one uint8 level of
             generate on the in-memory weights, the merged weight exact at
             one module, K1-K5 launched; file size, write and load seconds
  eval       the COCO evaluation as users run it: synthetic COCO instances
             and captions JSONs (8 images at COCO sizes, polygon and RLE
             masks, a crowd annotation, then a ninth image without
             annotations), then `evalsuite.coco_eval.main` (mask preset,
             50-step PLMS, CFG 7.5, mis 0, batch 8, --add_random_colors)
             from the cli phase's weights written as a flat SD-form file:
             8 JPEGs under their COCO names read back at 512x512, s/image
             and last_timings; each UNet forward (B=16), the VAE decode
             (B=8), each CLIP text encode and each UniFusion tokenization
             launches what the plan gives (`unet_launches`), the forwards
             number the PLMS schedule's and nothing launches outside them
             (the slice request's counts follow from the same plan); PiM
             with the ground-truth masks as predictions (point mode: the
             share of masks holding their own bbox center, counted
             without the pim module); attribute binding with CLIPJudge at
             ViT-L/14 (densified random weights, fp32) on every instance
             crop, timed as the metric calls it: ms/crop, features finite
  datagen    training records as users make them: an oracle COCO JSON over
             the fixture JPEGs, `datagen.label.main --ckpt --write_train_txt`
             (ClipPhraseEmbedder in bf16 on the card), then
             `datagen.coco_to_training_jsons.main` over the same JSON; both
             read back by JsonDataset (a B=4 batch each); records/s,
             phrases/s, record bytes; 25 LayerNorm launches per CLIP encode
  resume     training save and resume at full width (Config(), B=4): one
             step, save_train_ckpt into an auto-resume folder, a fresh state
             restored from it, one more step on both with the same draws:
             equal losses, parameters, EMA, optimizer steps and learning
             rate, frozen weights bf16; file size, save and restore seconds
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
  trainer    the training driver as users run it: 12 JSON records of the
             committed fixture JPEGs (tests/torch_fixtures/jpeg; their decode
             and center crop first held to PIL's recorded hashes), the
             loader's stages timed on one B=4 batch, the smoke's weights as a
             flat SD-form --official_ckpt, then `python -m
             instancediffusion_tpu_torch.launch` in a subprocess (Config(),
             B=4, 6 steps, checkpoint_latest every 3, a tagged checkpoint and
             one 50-step sample grid at step 6) and again to 8 steps, which
             must auto-resume at 6: finite losses, the step counts, the
             tag00 / tag01 layout, the (2048, 1024) RGB grid and
             captions.txt, launches per step; loader, data wait, s/step,
             samples/s, peak memory, load / save / restore and grid seconds
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

import collections
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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
# the SDXL refiner's B=16 forward at 512 px (8 images under CFG): its ds2
# self-attention (12 heads of 64) on the packed kernel, its ds2 feed-forward
# (C=768, inner 3072) on the fused kernel (clusters of three blocks), the
# GroupNorm widths its decoder joins reach (3072 takes the wide form) and
# its LayerNorm rows
REFINER_ATTN = (1024, 12, 64)
GN_REFINER_B16 = ((256, 3072, 1e-5, "silu"), (64, 3072, 1e-5, "silu"), (256, 2304, 1e-5, "silu"),
                  (1024, 2304, 1e-5, "silu"), (1024, 1536, 1e-5, "silu"),
                  (1024, 768, 1e-6, "none"), (4096, 384, 1e-5, "silu"))
LN_REFINER_B16 = ((1024, 768), (256, 1536), (64, 1536))
FF_REFINER = ((1024, 768),)
REFINER_STRENGTH = 0.35  # the CLI's --cascade_strength in the smoke: 7 of 20 DDIM steps
REFINER_STEPS = 20
REFINER_PATH = ("flash_attention_packed", "fused_group_norm", "fused_layer_norm",
                "fused_ff_geglu")

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
    cases += _refiner_cases(torch, randn, case)
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


def _refiner_cases(torch, randn, case):
    """K2, K3, K4 and K5 at the SDXL refiner's B=16 forward (512 px): the
    ds2 self-attention (12 heads of 64), the GroupNorm rows of its widest
    joins, its LayerNorm rows and its ds2 feed-forward (C=768). Device time
    as the main cases; reported in the kernels line under `refiner_*`."""
    import torch.nn.functional as F

    from instancediffusion_tpu_torch.kernels import flash_attention as fa
    from instancediffusion_tpu_torch.kernels import norms
    from instancediffusion_tpu_torch.ops.attention import sdpa_fp32

    b = FUSED_UNET_B
    n, h, c = REFINER_ATTN
    heads = lambda t: t.reshape(b, n, h, c).transpose(1, 2)
    q, k, v = (randn(b, n, h * c) for _ in range(3))
    cases = [case(
        "flash_attention_packed", f"refiner B={b} ds2 self {n}x{n} {h}x{c}",
        lambda: fa.flash_attention_packed(q, k, v, h),
        lambda: sdpa_fp32(heads(q), heads(k), heads(v)).transpose(1, 2).reshape(b, n, h * c),
        BF16_REL_TOL, _attn_work("fwd", b, h, n, n, c),
        lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)))]
    for rows, ch, eps, act in GN_REFINER_B16:
        x = randn(b, rows, ch, std=3.0) + 0.5
        sc, bi = randn(ch), randn(ch)
        xt = x.transpose(1, 2).contiguous()

        def lib(xt=xt, sc=sc, bi=bi, e=eps, a=act):
            y = F.group_norm(xt, 32, sc, bi, e)
            return F.silu(y) if a == "silu" else y

        cases.append(case(
            "fused_group_norm", f"refiner ({b},{rows},{ch}) eps={eps} {act}",
            lambda x=x, sc=sc, bi=bi, e=eps, a=act: norms.fused_group_norm(x, sc, bi, 32, e, a),
            lambda x=x, sc=sc, bi=bi, e=eps, a=act: norms.group_norm_plain(x, sc, bi, 32, e, a),
            BF16_REL_TOL, (8 * b * rows * ch, 2 * 2 * b * rows * ch + 4 * ch), lib, PEAK_FP32))
    for rows, ch in LN_REFINER_B16:
        x = (randn(b, rows, ch, std=2.0) + 0.3).to(torch.bfloat16)
        sc, bi = randn(ch), randn(ch)
        cases.append(case(
            "fused_layer_norm", f"refiner ({b},{rows},{ch}) eps=1e-05 bfloat16",
            lambda x=x, sc=sc, bi=bi: norms.fused_layer_norm(x, sc, bi, 1e-5),
            lambda x=x, sc=sc, bi=bi: norms.layer_norm_plain(x, sc, bi, 1e-5),
            BF16_REL_TOL, (8 * b * rows * ch, 2 * 2 * b * rows * ch + 4 * ch),
            lambda x=x, sc=sc, bi=bi: F.layer_norm(x, (x.shape[-1],), sc, bi, 1e-5), PEAK_FP32))
    for rows, ch in FF_REFINER:
        cases.append(_ff_case(randn, case, b, rows, ch))
        cases[-1]["label"] = "refiner " + cases[-1]["label"]
    for cs in cases:
        cs["main"] = cs["refiner"] = True
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
            which = "refiner" if cs.get("refiner") else "main"
            extra = ""
            if cs.get("refiner"):
                plain_dev_ms = device_ms(torch, plain, reps=3)
                extra = f" plain_device_ms={plain_dev_ms:.4f}"
            if f"{which}_device_ms" not in entry:
                entry.update({f"{which}_label": label, f"{which}_device_ms": dev_ms,
                              f"{which}_library_ms": lib_ms, f"{which}_bound_ms": bound_ms,
                              f"{which}_bound_by": bound_by})
                if exp_ms is not None:
                    entry[f"{which}_exp_bound_ms"] = exp_ms
                if cs.get("refiner"):
                    entry["refiner_plain_ms"] = plain_dev_ms
            if name == "flash_attention" and entry.get("main_label") == label:
                enc = []
                for _ in range(MAIN_REPS):
                    kern()
                    enc.append(fa.encode_us())
                extra = f" tensor_map_encode_us={sum(enc) / len(enc):.2f} (host, per call)"
            if name.startswith("flash_attention_bwd") and entry.get("main_label") == label:
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
# checkpoint files from the port's modules
# ---------------------------------------------------------------------------


# the LoRA the cli phase merges: kohya names of the ds1 spatial
# transformers (diffusers down_blocks.0 attentions 0-1, up_blocks.3
# attentions 0-2), attn1 / attn2 to_q and to_out.0, and one proj_out
LORA_RANK = 4
LORA_WIDTH = 320  # the ds1 transformers' width at Config()
LORA_ALPHA = 4.0
LORA_SCALE = 0.8
LORA_DS1 = ("down_blocks_0_attentions_0", "down_blocks_0_attentions_1",
            "up_blocks_3_attentions_0", "up_blocks_3_attentions_1", "up_blocks_3_attentions_2")
LORA_PROJ_OUT = "up_blocks_3_attentions_2"
# checked module: down_blocks_0_attentions_0 attn1 to_q = input_blocks[1]
LORA_CHECK = ("down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q",
              "input_blocks.1.1.blocks.0.attn1.to_q.weight")


def lora_state_dict(torch) -> dict:
    """A kohya-format LoRA (fp32 CPU tensors) on the ds1 attentions' to_q /
    to_out.0 (attn1 and attn2) and one proj_out, rank LORA_RANK, from a
    seeded generator; `up` scaled so the merge moves the images."""
    g = torch.Generator().manual_seed(5)
    width = LORA_WIDTH
    mods = [f"{blk}_transformer_blocks_0_{a}_{t}" for blk in LORA_DS1
            for a in ("attn1", "attn2") for t in ("to_q", "to_out_0")]
    sd = {}
    for mod in mods + [f"{LORA_PROJ_OUT}_proj_out"]:
        down = torch.randn(LORA_RANK, width, generator=g) / math.sqrt(width)
        up = torch.randn(width, LORA_RANK, generator=g) * 0.5
        if mod.endswith("proj_out"):
            down, up = down[..., None, None], up[..., None, None]
        sd[f"lora_unet_{mod}.lora_down.weight"] = down
        sd[f"lora_unet_{mod}.lora_up.weight"] = up
        sd[f"lora_unet_{mod}.alpha"] = torch.tensor(LORA_ALPHA)
    return sd


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


# ---------------------------------------------------------------------------
# the SDXL-Refiner cascade
# ---------------------------------------------------------------------------


def refiner_launches(cfg, text_cfg, vae_cfg, px: int, b: int, keep: int) -> dict:
    """Kernel launches (and unfused feed-forward calls) one `refine` of b
    images at px pixels makes, from the refiner's plan: `keep` UNet forwards
    at 2b rows (each GroupNorm of its res blocks, spatial transformers and
    output head; three LayerNorms a transformer block; the packed attention
    where a self-attention is long (`is_big`: 1024 tokens); the fused FF
    where `ff_fits`), one OpenCLIP encode (two LayerNorms a layer and the
    final one) and the VAE's encode and decode (two GroupNorms a res block,
    the middle's attention norm, the output norm)."""
    from instancediffusion_tpu_torch.kernels.geglu_ff import ff_fits
    from instancediffusion_tpu_torch.models.sdxl_refiner import build_refiner_plan
    from instancediffusion_tpu_torch.ops.attention import is_big

    inp, mid, out = build_refiner_plan(cfg)
    specs = [sp for blk in inp + [mid] + out for sp in blk]
    attn = [sp for sp in specs if sp.kind == "attn"]
    n_res = sum(sp.kind == "res" for sp in specs)
    tokens = lambda sp: (px // 8 // sp.ds) ** 2
    depth = cfg.transformer_depth
    fits = [ff_fits(2 * b * tokens(sp), sp.out_ch, 4 * sp.out_ch) for sp in attn]
    per_fwd = {"flash_attention_packed": depth * sum(is_big(tokens(sp), tokens(sp))
                                                     for sp in attn),
               "fused_group_norm": 2 * n_res + len(attn) + 1,
               "fused_layer_norm": 3 * depth * len(attn),
               "fused_ff_geglu": depth * sum(fits),
               FF_ROUTE: depth * (len(attn) - sum(fits))}
    want = {k: keep * v for k, v in per_fwd.items()}
    levels, blocks = len(vae_cfg.ch_mult), vae_cfg.num_res_blocks
    want["fused_group_norm"] += (2 * levels * blocks + 6) + (2 * levels * (blocks + 1) + 6)
    want["fused_layer_norm"] += 2 * text_cfg.num_hidden_layers + 1
    return want


def phase_refiner(torch, dev, card: str) -> tuple[str, dict]:
    """The SDXL-Refiner cascade at its published widths (2.3 B-parameter
    UNet, OpenCLIP-bigG, the SD VAE at scale 0.13025) on densified random
    weights: (a) one B=2 UNet forward at 512 px with the kernels against
    plain_kernels(), every kernel of the path launched; the B=16 forward's
    time; (b) `refine` of 8 images at 512 px, 20 DDIM steps at strength
    0.35 (7 kept) with CFG as one B=16 forward, one warm-up then one timed
    call with the launch counts set to 0 just before it, held to the
    counts the plan gives; (c) the same for one image at 1024 px, the
    refiner's native size. s/refine, its stages and peak memory."""
    import numpy as np

    from instancediffusion_tpu_torch import kernels
    from instancediffusion_tpu_torch.models.sdxl_refiner import (
        apply_refiner_unet, refiner_adm_vector,
    )
    from instancediffusion_tpu_torch.nn.core import plain_kernels
    from instancediffusion_tpu_torch.pipeline_refiner import SDXLRefinerPipeline

    t0 = time.perf_counter()
    rp = SDXLRefinerPipeline.random_init(seed=5, device=dev)
    for i, m in enumerate((rp.unet, rp.vae, rp.text)):
        densify_(m, 20 + i)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_unet = sum(p.numel() for p in rp.unet.parameters())
    n_text = sum(p.numel() for p in rp.text.parameters())

    g = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    lat = 512 // 8
    x = torch.randn((2, lat, lat, 4), generator=g, device=dev).to(bf)
    t = torch.tensor([600, 600], device=dev)
    ctx = torch.randn((2, 77, rp.cfg.context_dim), generator=g, device=dev).to(bf)
    pooled = torch.randn((2, rp.text_cfg.projection_dim), generator=g, device=dev)
    y = refiner_adm_vector(pooled, (512, 512), (0, 0), 6.0).to(bf)
    with torch.inference_mode():
        run = lambda: apply_refiner_unet(rp.unet, x, t, ctx, y)
        kernels.reset_launch_counts()
        eps_k = run()
        fwd_launches = dict(kernels.LAUNCHES)
        with plain_kernels():
            eps_p = run()
        torch.cuda.synchronize()
        x16, t16 = x.repeat(8, 1, 1, 1), t.repeat(8)
        ctx16, y16 = ctx.repeat(8, 1, 1), y.repeat(8, 1)
        fwd16_ms = median_ms(lambda: apply_refiner_unet(rp.unet, x16, t16, ctx16, y16), reps=3)
    if eps_k.shape != x.shape or not torch.isfinite(eps_k.float()).all():
        raise RuntimeError(f"refiner: bad eps {tuple(eps_k.shape)}")
    err = (eps_k.float() - eps_p.float()).abs().max().item()
    scale = eps_p.float().abs().max().item()
    rel = err / max(scale, 1e-12)
    missing = [k for k in REFINER_PATH if fwd_launches.get(k, 0) <= 0]
    if scale == 0.0 or rel > UNET_REL_TOL or missing:
        raise RuntimeError(f"refiner: forward kernels vs plain rel err {rel:.3g} (max |eps| "
                           f"{scale:.3g}, tol {UNET_REL_TOL}); not launched: {missing}")
    del eps_k, eps_p

    rng = np.random.default_rng(0)
    keep = max(1, min(int(REFINER_STEPS * REFINER_STRENGTH), REFINER_STEPS))
    runs = []
    for b, px in ((N_IMAGES, 512), (1, 1024)):
        imgs = rng.uniform(0.0, 1.0, (b, px, px, 3)).astype(np.float32)
        kw = dict(strength=REFINER_STRENGTH, steps=REFINER_STEPS)
        t0 = time.perf_counter()
        rp.refine(imgs, META["prompt"], seed=0, **kw)
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = rp.refine(imgs, META["prompt"], seed=1, **kw)
        secs = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        calls = {k: launches.get(k, 0) for k in REFINER_PATH}
        calls[FF_ROUTE] = kernels.ROUTES[FF_ROUTE]
        want = refiner_launches(rp.cfg, rp.text_cfg, rp.vae_cfg, px, b, keep)
        if calls != want:
            raise RuntimeError(f"refiner {px}px B={b}: launches {calls}, the plan gives {want}")
        if (out.shape != imgs.shape or not np.isfinite(out).all() or out.min() < 0
                or out.max() > 1 or float(out.std()) == 0.0):
            raise RuntimeError(f"refiner {px}px: output {out.shape}, range "
                               f"[{out.min()}, {out.max()}]")
        runs.append((b, px, warm_s, secs, torch.cuda.max_memory_allocated() / 2**30,
                     dict(rp.last_timings), launches, calls))
    del rp
    torch.cuda.empty_cache()
    parts = []
    for b, px, warm_s, secs, peak, timings, _, calls in runs:
        stages = ", ".join(f"{k} {v:.3f}s" for k, v in timings.items())
        parts.append(f"refine B={b} at {px}px: warm-up {warm_s:.2f}s, {secs:.3f} s/refine "
                     f"({secs / b:.4f} s/image; {stages}), peak {peak:.2f} GiB, launches and "
                     f"unfused FF calls {calls} (as the plan gives)")
    line = (f"refiner: SDXL-Refiner UNet {n_unet / 1e9:.3f} B params, OpenCLIP-bigG "
            f"{n_text / 1e6:.0f} M, bf16, random_init + densify {init_s:.1f}s; B=2 forward at "
            f"512px kernels vs plain max_abs_err={err:.4g} max|eps|={scale:.4g} rel={rel:.3g} "
            f"tol={UNET_REL_TOL}; B=16 forward {fwd16_ms:.2f} ms (host clock, median of 3); "
            f"{REFINER_STEPS} DDIM steps at strength {REFINER_STRENGTH} ({keep} kept), CFG 5 "
            f"as one 2B forward: " + "; ".join(parts) + f" on {card}")
    return line, runs[0][6]


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
# checkpoint files: the demo CLI, training resume
# ---------------------------------------------------------------------------


class _CaptureLoads:
    """Within the block, the pipelines InstanceDiffusionPipeline.
    from_checkpoint builds are also appended to `pipes`."""

    def __init__(self, cls):
        self.cls, self.pipes = cls, []

    def __enter__(self):
        self.orig = self.cls.__dict__["from_checkpoint"]
        load = self.orig.__func__

        def wrapped(klass, *args, **kwargs):
            self.pipes.append(load(klass, *args, **kwargs))
            return self.pipes[-1]

        self.cls.from_checkpoint = classmethod(wrapped)
        return self

    def __exit__(self, *exc):
        self.cls.from_checkpoint = self.orig


def _lora_expected(torch, w, lora: dict) -> "torch.Tensor":
    """W + LORA_SCALE * (alpha / rank) * up @ down at the checked module, in
    float32 (numpy's product, as `io/lora` takes it), rounded to W's dtype."""
    import numpy as np

    mod = LORA_CHECK[0]
    down = lora[f"lora_unet_{mod}.lora_down.weight"].numpy()
    up = lora[f"lora_unet_{mod}.lora_up.weight"].numpy()
    delta = (down.T @ up.T) * np.float32(LORA_ALPHA / LORA_RANK) * np.float32(LORA_SCALE)
    d = torch.from_numpy(np.ascontiguousarray(delta.T)).to(w.device)
    return (w.float() + d).to(w.dtype)


def phase_cli(torch, pipe, card: str) -> tuple[str, dict]:
    """The demo CLI at full width from checkpoint files: the smoke's bf16
    weights written as a flat SD-form checkpoint (with the stock first conv
    in pretrained/) and a kohya LoRA, then `inference.main` in-process on
    demo_fox_meadow.json --use_masks, 8 images, 50 steps, the default mask
    preset and mis 0.36, without and with --lora; the LoRA run also with
    --cascade_strength 0.35 (the SDXL refiner on its seeded random weights
    refines the 8 images). Checks that the loaded
    weights equal the in-memory ones bit for bit, that the PNGs are written
    and lie within one uint8 level of `generate` on the in-memory weights
    (same meta and seed), that the merged weight is W + scale * up @ down at
    the checked module and the LoRA images differ, that K1-K5 launched
    in the plain run, and that the cascade wrote 8 refined 512x512 PNGs
    under the JAX CLI's names through the refiner's kernels (K2 and K5
    launches beyond the plain run's: the refine's). Returns the line and
    the plain run's launches."""
    import re

    import numpy as np

    from instancediffusion_tpu_torch import inference, kernels
    from instancediffusion_tpu_torch.config import (
        Config, OpenCLIPTextConfig, RefinerUNetConfig, apply_test_preset,
    )
    from instancediffusion_tpu_torch.io import checkpoint as ckpt_io
    from instancediffusion_tpu_torch.io.checkpoint import FIRST_CONV_FILE
    from instancediffusion_tpu_torch.io.png import read_png
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline
    from instancediffusion_tpu_torch.pipeline_refiner import REFINER_VAE, SDXLRefinerPipeline

    demo = os.path.join(os.path.dirname(os.path.abspath(__file__)), "demos",
                        "demo_fox_meadow.json")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    cwd = os.getcwd()
    try:
        t0 = time.perf_counter()
        ckpt = os.path.join(tmp, "instancediffusion_smoke.pth")
        torch.save(ckpt_io.reference_state_dict(pipe.unet, pipe.vae, pipe.clip), ckpt)
        os.makedirs(os.path.join(tmp, "pretrained"))
        conv = pipe.unet.first_conv_sd
        torch.save({"weight": conv.weight.detach().cpu(), "bias": conv.bias.detach().cpu()},
                   os.path.join(tmp, FIRST_CONV_FILE))
        write_s = time.perf_counter() - t0
        size = os.path.getsize(ckpt)
        lora = lora_state_dict(torch)
        lora_path = os.path.join(tmp, "lora_ds1.pt")
        torch.save(lora, lora_path)
        dtype = str(pipe.dtype).replace("torch.", "")
        log(f"cli: wrote the flat SD-form checkpoint ({size / 1e9:.3f} GB, {dtype}, "
            f"{write_s:.2f}s) and a kohya LoRA ({len(lora)} tensors) under {tmp}")

        os.chdir(tmp)  # from_checkpoint finds pretrained/ under the working directory
        args = ["--input_json", demo, "--use_masks", "--ckpt", ckpt, "--num_images",
                str(N_IMAGES), "--steps", str(STEPS), "--output", os.path.join(tmp, "out")]
        runs = {}
        refine_s = []
        real_refine = SDXLRefinerPipeline.refine

        def timed_refine(self, *a, **kw):
            t = time.perf_counter()
            out = real_refine(self, *a, **kw)
            refine_s.append(time.perf_counter() - t)
            return out

        SDXLRefinerPipeline.refine = timed_refine
        for name, extra in (("plain", []), ("lora", ["--lora", lora_path, "--lora_scale",
                                                     str(LORA_SCALE), "--cascade_strength",
                                                     str(REFINER_STRENGTH)])):
            with _CaptureLoads(InstanceDiffusionPipeline) as cap:
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                paths = inference.main(args + extra)
                secs = time.perf_counter() - t0
                launches = dict(kernels.LAUNCHES)
            if len(cap.pipes) != 1:
                raise RuntimeError(f"cli {name}: {len(cap.pipes)} checkpoint loads")
            refined = [p for p in paths if "_xl_s" in os.path.basename(p)]
            paths = [p for p in paths if p not in refined]
            if name == "lora":
                names = [os.path.basename(p) for p in refined]
                pngs = [read_png(open(p, "rb").read()) for p in refined]
                if (len(names) != N_IMAGES or not all(re.fullmatch(
                        rf"\d+_xl_s{REFINER_STRENGTH}_n{REFINER_STEPS}\.png", n) for n in names)
                        or any(im.shape != (512, 512, 3) or im.dtype != np.uint8 for im in pngs)):
                    raise RuntimeError(f"cli cascade: refined files {names}")
            elif refined:
                raise RuntimeError(f"cli {name}: refined files without --cascade_strength")
            imgs = np.stack([read_png(open(p, "rb").read()) for p in paths])
            boxes = os.path.join(os.path.dirname(paths[0]),
                                 os.path.basename(paths[0]).replace(".png", "_boxes.png"))
            if read_png(open(boxes, "rb").read()).shape != (512, 512, 3):
                raise RuntimeError(f"cli {name}: no 512x512 boxes image at {boxes}")
            runs[name] = (cap.pipes[0], secs, launches, imgs)
        os.chdir(cwd)
        SDXLRefinerPipeline.refine = real_refine

        # the loaded weights against the in-memory ones, bit for bit
        loaded = runs["plain"][0]
        diff = []
        for part in ("unet", "vae", "clip"):
            mine = dict(getattr(pipe, part).named_parameters())
            for n, p in getattr(loaded, part).named_parameters():
                if p.dtype != mine[n].dtype or not torch.equal(p, mine[n]):
                    diff.append(f"{part}.{n}")
        if diff:
            raise RuntimeError(f"cli: loaded weights differ from the in-memory ones: {diff[:5]}")
        w_mem = pipe.unet.get_parameter(LORA_CHECK[1])
        w_lora = runs["lora"][0].unet.get_parameter(LORA_CHECK[1])
        want = _lora_expected(torch, w_mem, lora)
        if not torch.equal(w_lora, want) or torch.equal(w_lora, w_mem):
            raise RuntimeError(f"cli: LoRA-merged {LORA_CHECK[1]} is not W + scale * up @ down "
                               f"(max diff {(w_lora.float() - want.float()).abs().max().item()})")

        # generate on the in-memory weights with the CLI's meta, seed and defaults
        cfg = apply_test_preset(Config(), "mask")
        mem = InstanceDiffusionPipeline(cfg, pipe.unet, pipe.vae, pipe.clip, pipe.tokenizer)
        meta = inference.parse_demo_json(demo, use_masks=True, rng=np.random.default_rng(0))
        meta["alpha_type"] = [0.75, 0.0, 0.25]
        t0 = time.perf_counter()
        ref = mem.generate(meta, num_images=N_IMAGES, steps=STEPS, guidance_scale=7.5,
                           alpha=0.75, mis=0.36, seed=0, sampler="plms")
        gen_s = time.perf_counter() - t0
    finally:
        SDXLRefinerPipeline.refine = real_refine
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    # the cascade's own launches: the LoRA run's beyond the plain run's (the
    # generate of both makes the same calls)
    keep = max(1, min(int(REFINER_STEPS * REFINER_STRENGTH), REFINER_STEPS))
    cascade = {k: runs["lora"][2].get(k, 0) - runs["plain"][2].get(k, 0)
               for k in ("flash_attention_packed", "fused_ff_geglu")}
    want = {k: v for k, v in refiner_launches(
        RefinerUNetConfig(), OpenCLIPTextConfig(), REFINER_VAE, 512, N_IMAGES, keep).items()
        if k in cascade}
    if cascade != want or len(refine_s) != 1:
        raise RuntimeError(f"cli cascade: refiner launches {cascade} (the plan gives {want}), "
                           f"{len(refine_s)} refine calls")
    plain, with_lora = runs["plain"][3], runs["lora"][3]
    size_px = pipe.image_size
    if plain.shape != (N_IMAGES, size_px, size_px, 3) or int(plain.max()) == int(plain.min()):
        raise RuntimeError(f"cli: images {plain.shape}")
    err = int(np.abs(plain.astype(int) - ref.astype(int)).max())
    lora_moved = float(np.abs(with_lora.astype(int) - plain.astype(int)).mean())
    if err > 1 or not lora_moved > 0:
        raise RuntimeError(f"cli: images vs in-memory generate max |diff| {err} (tol 1); "
                           f"LoRA images mean |diff| {lora_moved}")
    launches = runs["plain"][2]
    missing = [k for k in PLAIN_PATH if launches.get(k, 0) <= 0]
    if missing:
        raise RuntimeError(f"cli: kernels never launched: {missing} ({launches})")
    loads = ", ".join(f"{k} {sum(v[0].load_timings.values()):.2f}s (" + ", ".join(
        f"{stage} {sec:.2f}" for stage, sec in v[0].load_timings.items()) + ")"
        for k, v in runs.items())
    line = (f"cli: inference.main demo_fox_meadow --use_masks --ckpt (flat SD form, "
            f"{size / 1e9:.3f} GB {dtype}, written in {write_s:.2f}s; loads {loads}) "
            f"--num_images {N_IMAGES} --steps {STEPS} mask preset mis 0.36: "
            f"{runs['plain'][1]:.2f}s plain ({runs['plain'][1] / N_IMAGES:.4f} s/image incl. "
            f"the load), {runs['lora'][1]:.2f}s with --lora (rank {LORA_RANK}, "
            f"{len(lora) // 3} modules, scale {LORA_SCALE}) and --cascade_strength "
            f"{REFINER_STRENGTH} (refine of the {N_IMAGES} images {refine_s[0]:.3f}s, launches "
            f"{cascade}, {N_IMAGES} refined 512x512 PNGs); in-memory generate {gen_s:.2f}s "
            f"({gen_s / N_IMAGES:.4f} s/image) on {card}; weights bit-equal after load; images "
            f"vs in-memory generate max |diff| {err} uint8 (tol 1); merged {LORA_CHECK[1]} "
            f"exact; LoRA images mean |diff| {lora_moved:.2f}; launches {launches}")
    del runs
    return line, launches


def smoke_train_state(torch, dev, cfg, seed: int = 0):
    """The smoke's full-width training state: fp32 random init, densified
    weights, EMA, AdamW with the config's warm-up, frozen weights bf16."""
    from instancediffusion_tpu_torch.train import optimizer as popt
    from instancediffusion_tpu_torch.train import train_step as pts

    tc = cfg.train
    state = pts.init_train_state(cfg, seed=seed, device=dev)
    densify_(state.unet, 11 + 10 * seed)
    densify_(state.vae, 12 + 10 * seed)
    densify_(state.clip, 13 + 10 * seed)
    state.ema = popt.init_ema(state.unet)
    state.optimizer, state.scheduler = popt.make_optimizer(
        state.unet, tc.base_learning_rate, tc.weight_decay, tc.warmup_steps, tc.scheduler_type,
        tc.total_iters)
    return pts.cast_frozen_bf16(state)


def phase_resume(torch, dev, card: str) -> tuple[str, dict]:
    """Training save and resume at full width (Config(), B=4 at 512 px):
    one step, save_train_ckpt into an auto-resume folder, a fresh state
    (other random weights) that finds the checkpoint through
    expt_folder_with_auto_resume and restores it, then one step on both
    with the same draws. Checks equal losses, trainable parameters, EMA,
    optimizer step counts and learning rates, and bf16 frozen weights.
    Returns the line and the launches of the two steps."""
    from instancediffusion_tpu_torch import kernels
    from instancediffusion_tpu_torch.config import Config
    from instancediffusion_tpu_torch.io import checkpoint as ckpt_io
    from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
    from instancediffusion_tpu_torch.train import optimizer as popt
    from instancediffusion_tpu_torch.train import train_step as pts

    cfg = Config()
    dc = cfg.diffusion
    step = pts.make_train_step(cfg, make_diffusion_schedule(
        dc.beta_schedule, dc.timesteps, dc.linear_start, dc.linear_end))
    batch = train_batch(torch, dev, cfg, TRAIN_B)
    gen = torch.Generator(device=dev).manual_seed(7)
    draws = [pts.sample_draws(gen, TRAIN_B, pts.latent_shape(cfg, TRAIN_IMAGE)) for _ in range(2)]
    det = torch.backends.cudnn.deterministic
    # deterministic convolution backward (the trainable UniFusion convs),
    # so two states that hold equal weights take equal steps
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        a = smoke_train_state(torch, dev, cfg, seed=0)
        a, _ = step(a, batch, draws[0])
        folder, prev = ckpt_io.expt_folder_with_auto_resume(tmp, "resume")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = ckpt_io.save_train_ckpt(folder, a, dataclasses.asdict(cfg))
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        b = smoke_train_state(torch, dev, cfg, seed=1)
        _, prev = ckpt_io.expt_folder_with_auto_resume(tmp, "resume")
        if prev != path:
            raise RuntimeError(f"resume: auto-resume found {prev}, saved {path}")
        t0 = time.perf_counter()
        b = ckpt_io.restore_train_ckpt(prev, b)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        a, ma = step(a, batch, draws[1])
        b, mb = step(b, batch, draws[1])
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
    finally:
        torch.backends.cudnn.deterministic = det
        shutil.rmtree(tmp, ignore_errors=True)
    pa, pb = dict(a.unet.named_parameters()), dict(b.unet.named_parameters())
    bad = [n for n in pa if not torch.equal(pa[n], pb[n])]
    bad += [f"ema.{n}" for n in a.ema if not torch.equal(a.ema[n], b.ema[n])]
    frozen = [n for n, p in pb.items() if not popt.is_trainable(n) and p.dtype != torch.bfloat16]
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    steps_a = sorted({float(s["step"]) for s in sa.values()})
    steps_b = sorted({float(s["step"]) for s in sb.values()})
    lr_a, lr_b = a.scheduler.get_last_lr(), b.scheduler.get_last_lr()
    loss_a, loss_b = float(ma["loss"]), float(mb["loss"])
    per = _per_step(launches, TRAIN_PATH, 2)
    want = dict(TRAIN_LAUNCHES, fused_ff_geglu=FF_PER_STEP["fused_ff_geglu"])
    wrong = {k: per[k] for k, n in want.items() if per[k] != n}
    if (bad or frozen or steps_a != steps_b or lr_a != lr_b or a.step != b.step
            or not torch.equal(ma["loss"], mb["loss"]) or ma["skipped"] or wrong):
        raise RuntimeError(f"resume: continued vs resumed: loss {loss_a} vs {loss_b}, "
                           f"unequal {bad[:5]} ({len(bad)}), frozen not bf16 {frozen[:3]}, "
                           f"optimizer steps {steps_a} vs {steps_b}, lr {lr_a} vs {lr_b}, "
                           f"launches per step {per} (expected {want})")
    line = (f"resume: Config() B={TRAIN_B} {TRAIN_IMAGE}px: training state "
            f"{size / 1e9:.3f} GB (step, UNet, EMA, AdamW, schedule, VAE, CLIP) saved in "
            f"{save_s:.2f}s, found by expt_folder_with_auto_resume and restored into a fresh "
            f"state in {restore_s:.2f}s on {card}; next step continued vs resumed: loss "
            f"{loss_a:.6f} both, {len(pa)} parameters and {len(a.ema)} EMA tensors equal, "
            f"optimizer steps {steps_a}, lr {lr_a[0]:.6g}, frozen weights bf16; "
            f"launches per step {per}")
    del a, b
    return line, launches


# ---------------------------------------------------------------------------
# training records from the committed fixture JPEGs
# ---------------------------------------------------------------------------

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "torch_fixtures",
                           "jpeg")
PHRASES = ("person", "dog", "cat", "car", "bicycle", "chair", "cup", "bench", "bird", "kite")


def fixture_jpegs() -> list[str]:
    """The fixture JPEG file names, sorted (tools/make_torch_jpeg_fixtures.py)."""
    return sorted(f for f in os.listdir(FIXTURE_DIR) if f.endswith(".jpg"))


def training_records(n: int = 12, seed: int = 0) -> list[dict]:
    """n training records in the format tools/coco_to_training_jsons.py
    writes, built without an imaging library: the fixture JPEGs' own bytes
    (cycled), 5-30 instances each (discs and rectangles inside the image)
    with RLE masks (`geometry.rle_encode`), their bboxes taken from the
    masks, a phrase caption, and base64 768-float embeddings; all from
    numpy seed `seed`."""
    import base64

    import numpy as np

    from instancediffusion_tpu_torch.data import geometry as geo
    from instancediffusion_tpu_torch.data import _native

    rng = np.random.default_rng(seed)
    names = fixture_jpegs()
    records = []
    for i in range(n):
        name = names[i % len(names)]
        with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
            data = f.read()
        w, h, _, _ = _native.jpeg_info(data)
        y, x = np.mgrid[0:h, 0:w]
        annos = []
        for _ in range(int(rng.integers(5, 31))):
            mask = np.zeros((h, w), np.uint8)
            cx, cy = rng.uniform(0.1, 0.9) * w, rng.uniform(0.1, 0.9) * h
            rx, ry = rng.uniform(0.04, 0.3) * w, rng.uniform(0.04, 0.3) * h
            if rng.random() < 0.5:
                mask[((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2 < 1] = 1
            else:
                mask[max(int(cy - ry), 0):int(cy + ry), max(int(cx - rx), 0):int(cx + rx)] = 1
            ys, xs = np.nonzero(mask)
            x0, y0 = int(xs.min()), int(ys.min())
            phrase = PHRASES[int(rng.integers(len(PHRASES)))]
            emb = rng.standard_normal(768).astype(np.float32)
            annos.append({"bbox": [x0, y0, int(xs.max()) + 1 - x0, int(ys.max()) + 1 - y0],
                          "mask": geo.rle_encode(mask), "caption": phrase,
                          "text_embedding_before": base64.b64encode(emb.tobytes()).decode()})
        records.append({"data_id": i, "caption": f"a photo with {len(annos)} objects ({name})",
                        "image": base64.b64encode(data).decode(), "annos": annos})
    return records


COCO_SIZES = ((640, 480), (480, 640), (500, 375), (375, 500), (640, 427), (427, 640),
              (612, 612), (333, 251))


def _coco_polygon(rng, w: int, h: int) -> list:
    """A COCO polygon part: 4-24 vertices around a center at random radii
    (so it may cross itself), floats with one decimal, clipped to [0, w] x
    [0, h] as COCO's are (a vertex on the far border rounds to w or h)."""
    import numpy as np

    n = int(rng.integers(4, 25))
    cx, cy = rng.uniform(0.1, 0.9) * w, rng.uniform(0.1, 0.9) * h
    ang = np.sort(rng.uniform(0, 2 * np.pi, n)) if rng.random() < 0.7 else rng.uniform(0, 6.3, n)
    rad = rng.uniform(0.03, 0.45, n) * min(w, h)
    xs = np.clip(cx + rad * np.cos(ang), 0, w).round(1)
    ys = np.clip(cy + rad * np.sin(ang), 0, h).round(1)
    return [float(v) for xy in zip(xs, ys) for v in xy]


def synthetic_coco(images, seed: int = 0, empty_last: bool = True,
                   crowd: bool = True) -> tuple[dict, dict]:
    """COCO instances and captions JSON dicts for `images`, (file_name,
    width, height) tuples, from numpy seed `seed`: 1-8 instances an image
    with polygon segmentations (one or two parts, `_coco_polygon`) or RLE
    ones (an ellipse, `geometry.rle_encode`), bboxes from their extents, and
    one caption an image; with `crowd`, one more iscrowd annotation on the
    first image; with `empty_last`, the last image has no annotation."""
    import numpy as np

    from instancediffusion_tpu_torch.data import geometry as geo

    rng = np.random.default_rng(seed)
    cats = [{"id": i + 1, "name": name} for i, name in enumerate(PHRASES)]
    imgs, anns, caps = [], [], []
    for i, (name, w, h) in enumerate(images):
        img_id = 1000 + 7 * i
        imgs.append({"id": img_id, "file_name": name, "width": w, "height": h})
        caps.append({"id": 5000 + i, "image_id": img_id, "caption": f"a synthetic scene {i}. "})
        if empty_last and i == len(images) - 1:
            continue
        n = int(rng.integers(1, 9)) + (1 if crowd and i == 0 else 0)
        for k in range(n):
            if rng.random() < 0.6:
                seg = [_coco_polygon(rng, w, h) for _ in range(1 + int(rng.random() < 0.3))]
                pts = np.concatenate([np.reshape(p, (-1, 2)) for p in seg])
                x0, y0 = pts.min(0)
                x1, y1 = pts.max(0)
            else:
                y, x = np.mgrid[0:h, 0:w]
                cx, cy = rng.uniform(0.1, 0.9) * w, rng.uniform(0.1, 0.9) * h
                rx, ry = rng.uniform(0.03, 0.3) * w, rng.uniform(0.03, 0.3) * h
                mask = (((x - cx) / rx) ** 2 + ((y - cy) / ry) ** 2 < 1).astype(np.uint8)
                seg = geo.rle_encode(mask)
                ys, xs = np.nonzero(mask)
                x0, y0, x1, y1 = xs.min(), ys.min(), xs.max() + 1, ys.max() + 1
            anns.append({"id": 100 * i + k + 1, "image_id": img_id,
                         "category_id": int(rng.integers(1, len(cats) + 1)),
                         "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                         "area": float((x1 - x0) * (y1 - y0)), "segmentation": seg,
                         "iscrowd": int(crowd and i == 0 and k == n - 1)})
    return ({"images": imgs, "annotations": anns, "categories": cats},
            {"images": imgs, "annotations": caps})


def write_synthetic_coco(out_dir: str, images, seed: int = 0, **kw) -> tuple[str, str]:
    """`synthetic_coco` written as instances.json and captions.json under
    out_dir; returns both paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name, data in zip(("instances.json", "captions.json"), synthetic_coco(images, seed, **kw)):
        paths.append(os.path.join(out_dir, name))
        with open(paths[-1], "w") as f:
            json.dump(data, f)
    return paths[0], paths[1]


def write_training_records(out_dir: str, n: int = 12, seed: int = 0) -> str:
    """`training_records` as one JSON file each under out_dir, listed in
    out_dir/train.txt; returns the list's path."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, rec in enumerate(training_records(n, seed)):
        paths.append(os.path.join(out_dir, f"{i:05d}.json"))
        with open(paths[-1], "w") as f:
            json.dump(rec, f)
    listing = os.path.join(out_dir, "train.txt")
    with open(listing, "w") as f:
        f.write("\n".join(paths) + "\n")
    return listing


# ---------------------------------------------------------------------------
# evaluation and data generation
# ---------------------------------------------------------------------------

# the eval set: one image at each COCO size with annotations (a batch of
# N_IMAGES, so the UNet and the VAE decoder run at the kernels' held B=16 and
# B=8 shapes), then one without
EVAL_IMAGES = [(f"{1000 + 7 * i:012d}.jpg", w, h)
               for i, (w, h) in enumerate(COCO_SIZES + ((640, 424),))]
EVAL_ALPHA = 0.8  # coco_eval's --alpha default


def _record_calls(kernels, mod, name: str, key=lambda a, kw: None):
    """Wrap `mod.name` to record each call's kernel launches and unfused
    feed-forward calls, by key(args, kwargs); returns (records, undo)."""
    orig = getattr(mod, name)
    records: dict = {}

    def counts():
        return dict(kernels.LAUNCHES, **{FF_ROUTE: kernels.ROUTES[FF_ROUTE]})

    def counted(*a, **kw):
        before = counts()
        out = orig(*a, **kw)
        records.setdefault(key(a, kw), []).append(
            {k: v - before.get(k, 0) for k, v in counts().items() if v != before.get(k, 0)})
        return out

    setattr(mod, name, counted)
    return records, lambda: setattr(mod, name, orig)


def unet_launches(cfg, px: int, rows: int, gate: bool) -> dict:
    """Kernel launches and unfused feed-forward calls of one SD1.5 UNet
    forward over `rows` samples at px pixels, from the plan: two GroupNorms
    a res block, one a spatial transformer and the output norm; three
    LayerNorms a transformer block and two more in its fuser at gate on;
    its self-attention and the fuser's [x | objs] attention on the route
    `flash_route` gives (split heads at c=40, packed at c=80, plain on the
    short ds4 and ds8 sequences), the cross-attention over 77 tokens
    plain; a feed-forward a block and one in the fuser, fused where
    `ff_fits`. Zero counts are left out."""
    import torch

    from instancediffusion_tpu_torch.kernels.geglu_ff import ff_fits
    from instancediffusion_tpu_torch.models.unet import build_plan
    from instancediffusion_tpu_torch.models.unifusion import num_grounding_tokens
    from instancediffusion_tpu_torch.ops.attention import flash_route

    m = cfg.model
    inp, mid, out = build_plan(m)
    specs = [sp for blk in inp + [mid] + out for sp in blk]
    attn = [sp for sp in specs if sp.kind == "attn"]
    n_res = sum(sp.kind == "res" for sp in specs)
    n_objs = num_grounding_tokens(m.grounding_tokenizer, m.max_objs)
    impl = "kernel" if m.efficient_attention else "plain"
    by_route = {"split": "flash_attention", "packed": "flash_attention_packed"}
    want = collections.Counter({"fused_group_norm": 2 * n_res + len(attn) + 1})
    depth = m.transformer_depth
    for sp in attn:
        n, c = (px // 8 // sp.ds) ** 2, sp.out_ch // m.num_heads
        for kv in (n, n + n_objs) if gate else (n,):
            route = flash_route(impl, n, kv, torch.bfloat16, c)
            if route in by_route:
                want[by_route[route]] += depth
        fused = ff_fits(rows * n, sp.out_ch, 4 * sp.out_ch)
        want["fused_ff_geglu" if fused else FF_ROUTE] += depth * (2 if gate else 1)
        want["fused_layer_norm"] += depth * (5 if gate else 3)
    return dict(want)


def _plms_forwards(alpha: float, steps: int = STEPS) -> tuple[int, int]:
    """(gate-1, gate-0) UNet forwards of a PLMS request: one a step, two at
    the first (its pseudo improved Euler step)."""
    from instancediffusion_tpu_torch.config import Config
    from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
    from instancediffusion_tpu_torch.samplers.plms import make_plms_schedule

    d = Config().diffusion
    sched = make_plms_schedule(make_diffusion_schedule(d.beta_schedule, d.timesteps,
                                                       d.linear_start, d.linear_end),
                               steps, [alpha, 0.0, 1.0 - alpha])
    on = [g > 0 for g in sched.gates]
    n1 = int(sum(on)) + int(on[0])
    return n1, len(on) + 1 - n1


def _own_center_share(per_image) -> float:
    """PiM in point mode when each ground-truth mask is its own prediction,
    counted without the pim module: the image mean of the share of
    non-empty masks whose bbox center (from their row and column extents)
    they hold."""
    import numpy as np

    shares = []
    for masks, _ in per_image:
        hits = []
        for m in masks:
            rows, cols = np.flatnonzero(m.any(1)), np.flatnonzero(m.any(0))
            if len(rows):
                hits.append(int(m[(rows[0] + rows[-1]) // 2, (cols[0] + cols[-1]) // 2] == 1))
        if hits:
            shares.append(float(np.mean(hits)))
    return float(np.mean(shares))


def phase_eval(torch, dev, card: str, ckpt: str, slice_launches: dict) -> tuple[str, dict]:
    """The paper's COCO evaluation on the port: synthetic COCO instances and
    captions JSONs (8 images at COCO sizes with polygon and RLE masks and a
    crowd annotation, then one image without annotations), then
    `evalsuite.coco_eval.main` as users run it (the mask preset, 50-step
    PLMS, CFG 7.5, mis 0, batch 8, --add_random_colors) on the smoke's
    weights from `ckpt`: 8 JPEGs under their COCO names, each read back at
    512x512; every UNet forward's launches (B=16), the VAE decode's (B=8),
    every CLIP text encode's and every UniFusion tokenization's (its
    ConvNeXt over the segs, for the conditional rows and the null row) held
    to the counts their plans give, the UNet forwards to the PLMS
    schedule's number, and no launch outside them; PiM with the ground-truth masks standing in for a detector's (in
    point mode the share of masks that hold their own bbox center, counted
    directly); attribute binding with CLIPJudge at ViT-L/14 (densified
    random weights, fp32) on every instance crop, timed as the metric
    calls it."""
    import numpy as np

    from instancediffusion_tpu_torch import kernels
    from instancediffusion_tpu_torch.config import Config, apply_test_preset
    from instancediffusion_tpu_torch.data.jpeg import decode_image, encode_jpeg
    from instancediffusion_tpu_torch.evalsuite import attribute_binding as ab
    from instancediffusion_tpu_torch.evalsuite import coco_eval, pim
    from instancediffusion_tpu_torch.models import clip_text, unet, unifusion, vae
    from instancediffusion_tpu_torch.models.clip_vision import CLIPJudge

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    cfg = apply_test_preset(Config(), "mask")
    px, rows = 8 * cfg.model.image_size, 2 * N_IMAGES
    try:
        inst, caps = write_synthetic_coco(work, EVAL_IMAGES, seed=0)
        out_dir = os.path.join(work, "generated")
        gate_of = lambda a, kw: int(kw.get("gate_scale", 1.0) > 0)
        recorders = [_record_calls(kernels, unet, "apply_unet", gate_of),
                     _record_calls(kernels, vae, "vae_decode"),
                     _record_calls(kernels, clip_text, "apply_clip_text"),
                     _record_calls(kernels, unifusion, "apply_unifusion")]
        kernels.reset_launch_counts()
        try:
            res = coco_eval.main(["--instances_json", inst, "--captions_json", caps,
                                  "--ckpt_path", ckpt, "--save_dir", out_dir,
                                  "--add_random_colors", "--device", dev.type])
        finally:
            for _, undo in recorders:
                undo()
        launches = dict(kernels.LAUNCHES)
        n_unfused = kernels.ROUTES[FF_ROUTE]
        names = sorted(os.listdir(out_dir))
        want = sorted(n for n, _, _ in EVAL_IMAGES[:-1])
        if res["images"] != N_IMAGES or names != want:
            raise RuntimeError(f"eval: wrote {names} ({res['images']}), expected {want}")
        imgs = {}
        for name in names:
            with open(os.path.join(out_dir, name), "rb") as f:
                imgs[name] = decode_image(f.read())
            if imgs[name].shape != (512, 512, 3) or int(imgs[name].max()) == int(imgs[name].min()):
                raise RuntimeError(f"eval: {name} decodes to {imgs[name].shape}, or is flat")
        missing = [k for k in PLAIN_PATH if launches.get(k, 0) <= 0]
        if missing:
            raise RuntimeError(f"eval: kernels never launched: {missing} ({launches})")
        # the JPEG encoder on the host, per 512x512 image
        t0 = time.perf_counter()
        for _ in range(3):
            for img in imgs.values():
                encode_jpeg(img)
        jpeg_ms = (time.perf_counter() - t0) / (3 * len(imgs)) * 1e3

        # every call launches what its plan gives; nothing launches outside them
        per_gate = recorders[0][0]
        plan = {g: unet_launches(cfg, px, rows, bool(g)) for g in (1, 0)}
        levels, blocks = len(cfg.autoencoder.ch_mult), cfg.autoencoder.num_res_blocks
        decode_plan = {"fused_group_norm": 2 * levels * (blocks + 1) + 6}
        encode_plan = {"fused_layer_norm": 2 * cfg.text_encoder.num_hidden_layers + 1}
        # UniFusion's ConvNeXt over the seg masks: the stem's, each
        # downsample's and each block's LayerNorm
        gcfg = cfg.model.grounding_tokenizer
        depths = gcfg.convnext_depths
        tokens_plan = ({"fused_layer_norm": len(depths) + sum(depths)} if gcfg.use_segs else {})
        n1, n0 = _plms_forwards(EVAL_ALPHA)
        decodes = recorders[1][0].get(None, [])
        encodes = recorders[2][0].get(None, [])
        tokenizes = recorders[3][0].get(None, [])
        checks = [(f"gate-{g} UNet forward", r, plan[g]) for g in (1, 0)
                  for r in per_gate.get(g, [])]
        checks += [("VAE decode", r, decode_plan) for r in decodes]
        checks += [("CLIP text encode", r, encode_plan) for r in encodes]
        checks += [("UniFusion tokenization", r, tokens_plan) for r in tokenizes]
        for what, got, expect in checks:
            if got != expect:
                raise RuntimeError(f"eval: a {what} launched {got}, the plan gives {expect}")
        if (len(per_gate.get(1, [])), len(per_gate.get(0, [])), len(decodes)) != (n1, n0, 1):
            raise RuntimeError(f"eval: {len(per_gate.get(1, []))} + {len(per_gate.get(0, []))} "
                               f"UNet forwards and {len(decodes)} decodes; the schedule gives "
                               f"{n1} + {n0} and one batch one decode")
        total = collections.Counter()
        for _, got, _ in checks:
            total.update(got)
        if dict(total) != dict(launches, **{FF_ROUTE: n_unfused}):
            raise RuntimeError(f"eval: launched {launches} and {n_unfused} unfused FF calls, "
                               f"its UNet, decode, text encodes and UniFusion {dict(total)}")
        # the slice request (B=8, mis 0, alpha 0.75) runs the same forwards
        s1, s0 = _plms_forwards(0.75)
        unet_kernels = ("flash_attention", "flash_attention_packed", "fused_ff_geglu")
        slice_plan = {k: s1 * plan[1].get(k, 0) + s0 * plan[0].get(k, 0) for k in unet_kernels}
        slice_req = {k: slice_launches.get(k, 0) / 2 for k in unet_kernels}
        if slice_plan != slice_req:
            raise RuntimeError(f"eval: the plan gives the slice request {slice_plan}, it "
                               f"launched {slice_req}")

        # PiM: the ground-truth masks at 512 stand in for a detector's
        coco = coco_eval.CocoAnnotations(inst)
        by_name = {im["file_name"]: i for i, im in coco.imgs.items()}
        metas = {n: coco_eval.build_meta_for_image(
            coco, by_name[n], rng=np.random.default_rng(by_name[n]), attribute_mode="colors")
            for n in names}
        per_image = [([s.astype(np.uint8) for s in metas[n]["segs"]],
                      [s.astype(np.uint8) for s in metas[n]["segs"]]) for n in names]
        pim_point = pim.pim_score(per_image, "point")
        pim_scribble = pim.pim_score(per_image, "scribble")
        # each GT mask matches itself, so point mode is the share of masks that
        # hold their own bbox center: 1.0 for convex masks, less here, where
        # polygons cross themselves and some masks have two parts
        own = _own_center_share(per_image)
        if pim_point != own:
            raise RuntimeError(f"eval: PiM (point) {pim_point} with the GT masks as predictions, "
                               f"their own centers give {own}")

        # attribute binding: the ViT-L/14 judge on every instance crop, as
        # the metric calls it (one batch of crops and one of phrases an image)
        t0 = time.perf_counter()
        judge = CLIPJudge(generator=torch.Generator(device=dev).manual_seed(6), device=dev)
        densify_(judge, 40)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        judge_init_s = time.perf_counter() - t0
        samples = [(imgs[n], metas[n]["locations"], metas[n]["phrases"]) for n in names]
        n_crops = sum(c.size > 0 for img, locs, _ in samples for c in ab.crop_instances(img, locs))
        feats = []

        def kept(encode):
            return lambda items: feats.append(encode(items)) or feats[-1]

        ab.attribute_binding_eval(samples[:1], "colors", judge.encode_images,
                                  judge.encode_texts)  # warm-up
        t0 = time.perf_counter()
        scores = ab.attribute_binding_eval(samples, "colors", kept(judge.encode_images),
                                           kept(judge.encode_texts))
        crop_s = (time.perf_counter() - t0) / n_crops
        feats = np.concatenate(feats)
        norms = np.linalg.norm(feats, axis=-1)
        if not (np.isfinite(feats).all() and norms.min() > 0
                and np.abs(np.linalg.norm(feats / norms[:, None], axis=-1) - 1).max() < 1e-5):
            raise RuntimeError("eval: judge features not finite, zero or not unit after "
                               "normalising")
        timings = res["last_timings"][0]
        line = (f"eval: coco_eval.main ({len(names)} JPEGs of {len(EVAL_IMAGES)} COCO images, "
                f"mask preset, 50-step PLMS, alpha {EVAL_ALPHA}, batch {N_IMAGES}, bf16, "
                f"colours) {res['seconds']:.3f}s = {res['s_per_image']:.4f} s/image on {card} "
                f"(metas {res['seconds'] - sum(res['batch_s']):.3f}s, batch "
                f"{res['batch_s'][0]:.3f}s; JPEG encode {jpeg_ms:.2f} ms per 512x512 "
                f"image on the host; last_timings "
                f"{ {k: round(v, 4) for k, v in timings.items()} }); UNet forwards "
                f"{n1} gate-1 + {n0} gate-0 at B={rows}, each as the plan gives "
                f"({plan[1]} / {plan[0]}), one B={N_IMAGES} decode ({decode_plan}), "
                f"{len(encodes)} text encodes ({encode_plan} each), {len(tokenizes)} UniFusion "
                f"tokenizations ({tokens_plan} each); launches {launches}, "
                f"{n_unfused} unfused FF calls; the slice request (alpha 0.75: {s1} + {s0} "
                f"forwards) launched the plan's {slice_plan}; PiM point {pim_point:.4f} (the "
                f"share of GT masks holding their own bbox center) scribble "
                f"{pim_scribble:.4f} (GT masks as predictions); judge ViT-L/14 fp32 init "
                f"{judge_init_s:.2f}s, attribute_binding_eval on {n_crops} crops "
                f"{crop_s * 1e3:.2f} ms/crop ({len(feats)} features, finite and unit after "
                f"normalising), clip_score {scores['clip_score']:.4f} accuracy "
                f"{scores['accuracy']:.4f} (random weights: not gated); phase "
                f"{time.perf_counter() - t_phase:.1f}s")
        return line, launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_datagen(torch, dev, card: str, ckpt: str) -> tuple[str, dict]:
    """Training-data generation on the port: an oracle COCO JSON over the
    fixture JPEGs, `datagen.label.main` with --ckpt (ClipPhraseEmbedder on
    the card) and --write_train_txt, then
    `datagen.coco_to_training_jsons.main` over the same JSON and images;
    both outputs read back through JsonDataset / SampleDecoder (a B=4
    batch each). Records/s, phrases/s, record bytes; the CLIP text encodes'
    LayerNorm launches held to 25 an encode (12 layers x 2 + the final)."""
    import numpy as np

    from instancediffusion_tpu_torch import kernels
    from instancediffusion_tpu_torch.data import _native
    from instancediffusion_tpu_torch.data.jsondataset import JsonDataset, SampleDecoder
    from instancediffusion_tpu_torch.datagen import coco_to_training_jsons, label
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    from instancediffusion_tpu_torch.datagen.backends import ClipPhraseEmbedder

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_datagen_")
    encodes, loads = [], []
    orig, orig_init = InstanceDiffusionPipeline.encode_phrases, ClipPhraseEmbedder.__init__

    def counted(self, phrases):
        encodes.append(len(phrases))
        return orig(self, phrases)

    def timed_init(self, *a, **kw):
        t0 = time.perf_counter()
        orig_init(self, *a, **kw)
        loads.append(time.perf_counter() - t0)

    try:
        images = []
        for name in fixture_jpegs():
            with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
                w, h, _, _ = _native.jpeg_info(f.read())
            images.append((name, w, h))
        inst, _ = write_synthetic_coco(work, images, seed=1, empty_last=False)
        entries = os.path.join(work, "entries.json")
        with open(entries, "w") as f:
            json.dump([{"image": os.path.join(FIXTURE_DIR, n), "caption": f"scene {i}"}
                       for i, (n, _, _) in enumerate(images)], f)
        InstanceDiffusionPipeline.encode_phrases = counted
        ClipPhraseEmbedder.__init__ = timed_init
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        written = label.main(["--train_data_path", entries, "--output_dir",
                              os.path.join(work, "labels"), "--instances_json", inst,
                              "--ckpt", ckpt, "--write_train_txt", "--device", dev.type])
        label_s = time.perf_counter() - t0
        label_encodes = len(encodes)
        t0 = time.perf_counter()
        listing = coco_to_training_jsons.main(["--instances", inst, "--images_dir", FIXTURE_DIR,
                                               "--out", os.path.join(work, "records"),
                                               "--ckpt", ckpt, "--device", dev.type])
        c2t_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        if len(written) != len(images) or len(listing) != len(images):
            raise RuntimeError(f"datagen: {len(written)} labels, {len(listing)} records for "
                               f"{len(images)} images")
        ln = launches.get("fused_layer_norm", 0)
        if ln != 25 * len(encodes) or set(launches) - {"fused_layer_norm"}:
            raise RuntimeError(f"datagen: launches {launches} for {len(encodes)} CLIP encodes "
                               f"(25 LayerNorms each)")
        n_phr, sizes = 0, []
        for path in written:
            with open(path) as f:
                rec = json.load(f)
            n_phr += len(rec["annos"]) + sum(1 for a in rec["annos"] if a["caption"])
            sizes.append(os.path.getsize(path))
            for a in rec["annos"]:
                emb = np.frombuffer(__import__("base64").b64decode(a["text_embedding_before"]),
                                    np.float32)
                if emb.shape != (768,) or not np.isfinite(emb).all() or not emb.any():
                    raise RuntimeError(f"datagen: bad embedding in {path}")
        batches = []
        for txt in (os.path.join(work, "labels", "train.txt"),
                    os.path.join(work, "records", "train.txt")):
            ds = JsonDataset(txt, SampleDecoder(image_size=512, max_boxes_per_data=30))
            items = [ds[i] for i in range(4)]
            if any(it["image"].shape != (512, 512, 3) or int(it["text_masks"].sum()) <= 0
                   for it in items):
                raise RuntimeError(f"datagen: {txt} does not decode into a B=4 batch")
            batches.append(len(items))
        work_s = label_s - loads[0]
        line = (f"datagen: label.main on {len(images)} fixture JPEGs (oracle backend, "
                f"ClipPhraseEmbedder bf16 on {card}) {label_s:.2f}s, of it the checkpoint "
                f"load {loads[0]:.2f}s: {len(written) / work_s:.3f} records/s past the load "
                f"({len(written) / label_s:.3f} with it), {n_phr} phrases ({n_phr / work_s:.2f} "
                f"phrases/s, {label_encodes} batched encodes), record bytes mean "
                f"{np.mean(sizes):.0f} max {max(sizes)}; coco_to_training_jsons "
                f"{len(listing)} records in {c2t_s:.2f}s, load {loads[1]:.2f}s "
                f"({len(listing) / (c2t_s - loads[1]):.3f} records/s past it); JsonDataset B=4 "
                f"batches from both; launches {launches} ({len(encodes)} encodes); phase "
                f"{time.perf_counter() - t_phase:.1f}s")
        return line, launches
    finally:
        InstanceDiffusionPipeline.encode_phrases = orig
        ClipPhraseEmbedder.__init__ = orig_init
        shutil.rmtree(work, ignore_errors=True)


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


def phase_train(torch, dev, card: str) -> tuple[dict, dict, float]:
    """(launches of the timed steps, launches of the masked steps, s/step of
    the timed steps)."""
    import contextlib

    from instancediffusion_tpu_torch import kernels
    from instancediffusion_tpu_torch.config import Config, apply_test_preset
    from instancediffusion_tpu_torch.models import unifusion
    from instancediffusion_tpu_torch.nn.core import plain_kernels
    from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
    from instancediffusion_tpu_torch.train import optimizer as popt
    from instancediffusion_tpu_torch.train import train_step as pts

    cfg = Config()
    dc = cfg.diffusion
    t0 = time.perf_counter()
    state = smoke_train_state(torch, dev, cfg)
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
    s_per_step = secs / TRAIN_STEPS

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
    return launches, mlaunches, s_per_step


# the trainer phase: the launcher in a subprocess, as users run it
TRAINER_ITERS = (6, 8)  # the first run, then the resumed one
TRAINER_TRAIN = {"ckpt_every_iters": 3, "n_sample_batches": 1, "sample_steps": STEPS,
                 "workers": 4}
TRAINER_RECORDS = 12
TRAINER_TIMEOUT = 600  # seconds per launcher run


def check_fixture_hashes() -> int:
    """The port's decode and center crop of every fixture JPEG against the
    SHA-256s PIL and the JAX package gave (expected.json); returns the count."""
    import hashlib

    import numpy as np

    from instancediffusion_tpu_torch.data.jpeg import decode_image
    from instancediffusion_tpu_torch.data.jsondataset import center_crop_image

    with open(os.path.join(FIXTURE_DIR, "expected.json")) as f:
        expected = json.load(f)
    bad = []
    for name, want in sorted(expected.items()):
        with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
            img = decode_image(f.read())
        crop = np.ascontiguousarray(center_crop_image(img, 512, None)[0])
        if (hashlib.sha256(img.tobytes()).hexdigest() != want["rgb_sha256"]
                or hashlib.sha256(crop.tobytes()).hexdigest() != want["center_crop_512_sha256"]):
            bad.append(name)
    if bad or not expected:
        raise RuntimeError(f"trainer: decode / center crop differ from PIL's hashes: {bad}")
    return len(expected)


def loader_stages(records: list[dict], b: int = TRAIN_B, image_size: int = TRAIN_IMAGE) -> dict:
    """Host seconds of one batch of b records through the loader's stages,
    on one thread: image decode, RLE decode, point sampling (scribbles and
    polygon points, the border following included), resize (BOX halving,
    BICUBIC, NEAREST masks and the crop), and, timed apart, the whole
    SampleDecoder plus collate (the stages and boxes, segs to float32,
    captions, stacking)."""
    import copy

    import numpy as np

    from instancediffusion_tpu_torch.data import geometry as geo
    from instancediffusion_tpu_torch.data import jsondataset as jd

    rng = np.random.default_rng(0)
    t = dict(decode=0.0, rle=0.0, points=0.0, resize=0.0)
    for rec in records[:b]:
        t0 = time.perf_counter()
        img = jd.decode_base64_image(rec["image"])
        t1 = time.perf_counter()
        masks = [geo.rle_decode(a["mask"]).astype(np.uint8) for a in rec["annos"]]
        t2 = time.perf_counter()
        for m in masks:
            geo.sample_random_points_from_mask(m, jd.N_SCRIBBLE, rng)
            geo.sample_sparse_points_from_mask(m, jd.N_POLYGON, rng)
        t3 = time.perf_counter()
        jd.center_crop_image(img, image_size, np.stack([m[:, :, 0] for m in masks]))
        t4 = time.perf_counter()
        for k, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            t[k] += dt
    decoder = jd.SampleDecoder(image_size=image_size)
    t0 = time.perf_counter()
    jd.collate([decoder(copy.deepcopy(rec), np.random.default_rng(i))
                for i, rec in enumerate(records[:b])])
    t["whole"] = time.perf_counter() - t0
    return t


def _run_launcher(args: list[str], env: dict, log_path: str) -> tuple[float, str]:
    """Run `python -m instancediffusion_tpu_torch.launch args` from the
    repository root; (seconds, stdout). A non-zero exit raises with the end
    of its output."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "instancediffusion_tpu_torch.launch", *args],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=TRAINER_TIMEOUT)
    secs = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"trainer: launcher {' '.join(args[-4:])} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return secs, proc.stdout


def _trainer_stats(stdout: str) -> dict:
    lines = [l for l in stdout.splitlines() if l.startswith("trainer stats: ")]
    if len(lines) != 1:
        raise RuntimeError(f"trainer: {len(lines)} stats lines in the launcher's output")
    return json.loads(lines[0][len("trainer stats: "):])


def phase_trainer(torch, card: str, ckpt: str, train_s_per_step: float) -> tuple[str, dict]:
    """The training driver as users run it: 12 JSON records of the fixture
    JPEGs (their decode and center crop first checked against PIL's
    hashes), the smoke's weights as the --official_ckpt flat SD-form file,
    `python -m instancediffusion_tpu_torch.launch --batch_size 4
    --total_iters 6 --save_every_iters 6` with ckpt_every_iters 3, one
    50-step sample batch and 4 decode processes (a YAML config), then again
    with --total_iters 8, which must auto-resume at step 6. Checks finite
    losses, the step counts, the tag00 / tag01 layout with checkpoint_latest
    and checkpoint_00000006, the (2048, 1024) RGB sample grid and
    captions.txt, the launches per step, and both exit codes. Returns the
    line and the launches of both runs (steps and sample grids)."""
    from instancediffusion_tpu_torch.io.png import read_png

    n_hashes = check_fixture_hashes()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    try:
        listing = write_training_records(os.path.join(tmp, "records"), TRAINER_RECORDS)
        with open(listing) as f:
            records = [json.load(open(p)) for p in f.read().split()]
        stages = loader_stages(records)
        config = os.path.join(tmp, "trainer.yaml")  # JSON is YAML
        with open(config, "w") as f:
            json.dump({"train": TRAINER_TRAIN}, f)
        out = os.path.join(tmp, "OUTPUT")
        common = ["--yaml_file", config, "--train_list", listing, "--official_ckpt", ckpt,
                  "--batch_size", str(TRAIN_B), "--save_every_iters", str(TRAINER_ITERS[0]),
                  "--output_dir", out, "--name", "smoke"]
        env = dict(os.environ, IDTPU_ALLOW_HASH_TOKENIZER="1")
        torch.cuda.empty_cache()  # the launcher's process needs the card's memory
        runs = []
        for i, iters in enumerate(TRAINER_ITERS):
            secs, stdout = _run_launcher(common + ["--total_iters", str(iters)], env,
                                         os.path.join(tmp, f"launch{i}.log"))
            runs.append((secs, stdout, _trainer_stats(stdout)))
        first, second = runs[0][2], runs[1][2]
        base = os.path.join(out, "smoke")
        tags = sorted(os.listdir(base))
        tag0 = sorted(os.listdir(os.path.join(base, "tag00")))
        grid = read_png(open(os.path.join(base, "tag00", "samples_00000006", "batch0.png"),
                             "rb").read())
        captions = os.path.exists(os.path.join(base, "tag00", "samples_00000006",
                                               "captions.txt"))
        tag1 = sorted(os.listdir(os.path.join(base, "tag01")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    resumed = "auto-resumed from" in runs[1][1] and "at step 6" in runs[1][1]
    losses = first["losses"] + second["losses"]
    want_per_step = dict(TRAIN_LAUNCHES, fused_ff_geglu=FF_PER_STEP["fused_ff_geglu"])
    per = {k: first["launches_per_step"].get(k, 0) for k in TRAIN_PATH}
    wrong = {k: per[k] for k, n in want_per_step.items() if per[k] != n}
    sample_missing = [k for k in PLAIN_PATH if first["sample_launches"].get(k, 0) <= 0]
    problems = []
    if not all(math.isfinite(x) for x in losses) or first["skipped"] or second["skipped"]:
        problems.append(f"losses {losses}, skipped {first['skipped']} / {second['skipped']}")
    if (first["steps"], first["final_step"], second["steps"], second["final_step"]) != (
            6, 6, 2, 8) or not resumed:
        problems.append(f"steps {first['steps']} to {first['final_step']}, then "
                        f"{second['steps']} to {second['final_step']}, resumed {resumed}")
    if tags != ["tag00", "tag01"] or not {"checkpoint_latest", "checkpoint_00000006",
                                          "samples_00000006"} <= set(tag0) \
            or "checkpoint_latest" not in tag1:
        problems.append(f"layout {tags}: tag00 {tag0}, tag01 {tag1}")
    if grid.shape != (2048, 1024, 3) or not captions:
        problems.append(f"sample grid {grid.shape}, captions.txt {captions}")
    if wrong or sample_missing:
        problems.append(f"launches per step {per} (expected {want_per_step}); sample grid "
                        f"kernels never launched {sample_missing}")
    if problems:
        raise RuntimeError("trainer: " + "; ".join(problems))
    launches: dict = {}
    for st in (first, second):
        for k, v in st["launches_per_step"].items():
            launches[k] = launches.get(k, 0) + round(v * st["steps"])
        for k, v in st["sample_launches"].items():
            launches[k] = launches.get(k, 0) + v
    stage_txt = ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
    line = (f"trainer: python -m instancediffusion_tpu_torch.launch --official_ckpt (flat SD "
            f"form) B={TRAIN_B} {TRAIN_IMAGE}px, {TRAINER_RECORDS} JPEG records ({n_hashes} "
            f"fixtures' decode and center crop equal PIL's hashes), {TRAINER_ITERS[0]} steps "
            f"then resumed at 6 to {TRAINER_ITERS[1]}: runs {runs[0][0]:.1f}s / "
            f"{runs[1][0]:.1f}s; loader s/batch by stage on one thread ({stage_txt}); "
            f"{TRAINER_TRAIN['workers']} decode processes: data wait {first['data_wait_s']:.4f} "
            f"s/step (within an epoch {first['data_wait_within_epoch_s']:.4f}, at an epoch's "
            f"first step {first['data_wait_epoch_start_s']:.4f}), {first['step_s']:.4f} s/step "
            f"(first step {first['first_step_s']:.2f}s; the train phase's synthetic batch "
            f"{train_s_per_step:.4f} s/step), {first['samples_per_s']:.3f} samples/s, peak "
            f"{first.get('peak_memory_gib', float('nan')):.2f} GiB; checkpoint load "
            f"{first['pretrained_s']:.2f}s, saves {[round(x, 2) for x in first['save_s']]} s, "
            f"restore {second['restore_s']:.2f}s, sample grid (1 batch, {STEPS} PLMS steps) "
            f"{[round(x, 2) for x in first['samples_s']]} s on {card}; losses "
            + ", ".join("%.4f" % x for x in losses)
            + f"; launches per step {per}; sample grid launches {first['sample_launches']}")
    return line, launches


def main() -> int:
    import torch

    # the port itself (in a directory without it, this fails before any output)
    from instancediffusion_tpu_torch.config import Config, apply_test_preset
    from instancediffusion_tpu_torch.io import checkpoint as ckpt_io
    from instancediffusion_tpu_torch.kernels import _build
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    t_start = time.perf_counter()
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

    # the SDXL-Refiner cascade at its published widths
    line, launches_refiner = phase_refiner(torch, dev, card)
    log(line)

    # checkpoint files: the demo CLI from a written checkpoint (and a
    # LoRA), then training save and resume
    line, launches_cli = phase_cli(torch, pipe, card)
    log(line)
    # the trainer phase's --official_ckpt: the same weights as a flat SD-form file
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_trainer_ckpt_")
    try:
        trainer_ckpt = os.path.join(ckpt_dir, "smoke_sd15_form.pth")
        torch.save(ckpt_io.reference_state_dict(pipe.unet, pipe.vae, pipe.clip), trainer_ckpt)
        del pipe, mpipe
        torch.cuda.empty_cache()

        # the COCO evaluation and the training-data generation, from that file
        line, launches_eval = phase_eval(torch, dev, card, trainer_ckpt, launches_plain)
        log(line)
        torch.cuda.empty_cache()
        line, launches_datagen = phase_datagen(torch, dev, card, trainer_ckpt)
        log(line)
        torch.cuda.empty_cache()
        line, launches_resume = phase_resume(torch, dev, card)
        log(line)
        torch.cuda.empty_cache()

        # the training step at full width, unmasked then masked
        launches_train, launches_masked, train_s_per_step = phase_train(torch, dev, card)
        torch.cuda.empty_cache()

        # the training driver: the launcher in a subprocess, then resumed
        line, launches_trainer = phase_trainer(torch, card, trainer_ckpt, train_s_per_step)
        log(line)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    kernels_json = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        by_path = {"slice": launches_plain.get(name, 0), "mis": launches_mis.get(name, 0),
                   "serve": launches_serve.get(name, 0),
                   "serve_unfused": launches_serve_unfused.get(name, 0),
                   "ddim": launches_ddim.get(name, 0), "img2img": launches_i2i.get(name, 0),
                   "cli": launches_cli.get(name, 0), "resume": launches_resume.get(name, 0),
                   "train": launches_train.get(name, 0),
                   "train_masked": launches_masked.get(name, 0),
                   "trainer": launches_trainer.get(name, 0),
                   "refiner": launches_refiner.get(name, 0),
                   "eval": launches_eval.get(name, 0), "datagen": launches_datagen.get(name, 0)}
        entry = {
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        }
        entry.update({k: r[k] for k in (
            "exp_bound_ms", "main_label", "main_device_ms", "main_library_ms", "main_bound_ms",
            "main_bound_by", "main_exp_bound_ms", "refiner_label", "refiner_device_ms",
            "refiner_library_ms", "refiner_plain_ms", "refiner_bound_ms", "refiner_bound_by",
            "refiner_exp_bound_ms") if k in r})
        if name in ONLY_KERNELS_PHASE:
            entry["checked"] = ONLY_KERNELS_PHASE[name]
        kernels_json.append(entry)
    log(f"smoke: every phase passed in {time.perf_counter() - t_start:.1f}s")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels_json}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
