"""Profile the PyTorch port's full-width training step on one CUDA card.

    python3 tools/torch_train_profile.py [--steps 2] [--masked] [--root DIR]

Builds the training state as chip_smoke.py's train phase does (Config(),
B=4 at 512 px, the batch bench.py builds from numpy seed 0, densified
weights, frozen weights bf16, AdamW, remat on), runs two warm-up steps,
times `--steps` steps on the host clock, then profiles `--steps` more with
torch.profiler and prints: the host-clock time per step without and with
the profiler, the device time per step by category and by kernel (top 30),
the device's busy share (device time per step over the unprofiled step
time; one stream, so kernels do not overlap) and the peak memory of the
unprofiled steps (`torch.cuda.max_memory_allocated`). `--masked` takes the
"mask" preset with use_masked_att. `--root DIR` imports the port and
`chip_smoke` from another checkout (parent against change in one call).
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import sys
import time


# (category, substrings of the kernel name), first match wins
CATEGORIES = (
    ("K6 flash forward + lse", ("flash_fwd_sm90<",)),
    ("dq kernel", ("flash_bwd_dq",)),
    ("dk/dv kernel", ("flash_bwd_dkv",)),
    ("GEGLU kernel", ("geglu_ff",)),
    ("GroupNorm kernel", ("::gn_kernel<",)),
    ("LayerNorm kernel", ("ln_rows_kernel", "ln_generic_kernel", "ln_kernel")),
    ("optimizer (foreach / multi-tensor)", ("multi_tensor", "foreach")),
    ("convolution (cuDNN)", ("conv", "cudnn", "implicit_gemm", "wgrad", "dgrad", "fprop")),
    # fp32 products outside the tensor cores (TF32 is off): cuBLAS's SIMT sgemm
    ("GEMM, fp32 SIMT (cuBLAS)", ("sgemm", "simt")),
    ("GEMM (cuBLAS)", ("gemm", "sm90_xmma", "cutlass", "splitKreduce", "nvjet")),
    ("reduction", ("reduce", "softmax")),
    ("copy / cast", ("copy", "Memcpy", "Memset", "cat")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in low for k in keys):
            return cat
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--masked", action="store_true")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from instancediffusion_tpu_torch.config import Config, apply_test_preset
    from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
    from instancediffusion_tpu_torch.train import optimizer as popt
    from instancediffusion_tpu_torch.train import train_step as pts

    if not torch.cuda.is_available():
        raise RuntimeError("torch_train_profile: no CUDA device")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = Config()
    if args.masked:
        cfg = apply_test_preset(cfg, "mask")
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, use_masked_att=True))
    tc = cfg.train
    state = pts.init_train_state(cfg, seed=0, device=dev)
    chip_smoke.densify_(state.unet, 11)
    chip_smoke.densify_(state.vae, 12)
    chip_smoke.densify_(state.clip, 13)
    state.ema = popt.init_ema(state.unet)
    state.optimizer, state.scheduler = popt.make_optimizer(
        state.unet, tc.base_learning_rate, tc.weight_decay, tc.warmup_steps, tc.scheduler_type,
        tc.total_iters)
    state = pts.cast_frozen_bf16(state)
    b = chip_smoke.TRAIN_B
    batch = chip_smoke.train_batch(torch, dev, cfg, b)
    latent = pts.latent_shape(cfg, chip_smoke.TRAIN_IMAGE)
    gen = torch.Generator(device=dev).manual_seed(0)
    step = pts.make_train_step(cfg, make_diffusion_schedule(
        cfg.diffusion.beta_schedule, cfg.diffusion.timesteps, cfg.diffusion.linear_start,
        cfg.diffusion.linear_end))
    for _ in range(2):
        step(state, batch, pts.sample_draws(gen, b, latent))
    draws = [pts.sample_draws(gen, b, latent) for _ in range(args.steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for d in draws:
        step(state, batch, d)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for d in draws:
            step(state, batch, d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    by_kernel: dict = collections.Counter()
    calls: dict = collections.Counter()
    for evt in prof.events():
        # kernels only: user annotations (e.g. "Optimizer.step#AdamW.step")
        # also appear on the device timeline and would count twice
        if evt.device_type == DeviceType.CUDA and not getattr(evt, "is_user_annotation", False):
            by_kernel[evt.name] += evt.time_range.elapsed_us()
            calls[evt.name] += 1
    by_cat: dict = collections.Counter()
    for name, us in by_kernel.items():
        by_cat[category(name)] += us
    busy = sum(by_kernel.values()) / 1e6
    n = args.steps
    print(f"card: {chip_smoke.card_line()}")
    print(f"train step ({'masked' if args.masked else 'unmasked'}, B={b}, "
          f"{chip_smoke.TRAIN_IMAGE}px, remat): host {plain_wall / n * 1e3:.1f} ms/step "
          f"({wall / n * 1e3:.1f} under the profiler), device {busy / n * 1e3:.1f} ms/step, "
          f"busy {100 * busy / plain_wall:.1f}% of the unprofiled step, peak memory "
          f"{peak / 2**30:.2f} GiB")
    print("device ms per step by category:")
    for cat, us in by_cat.most_common():
        print(f"  {us / n / 1e3:9.2f}  {100 * us / (busy * 1e6):5.1f}%  {cat}")
    print("device ms per step by kernel (top 30):")
    for name, us in by_kernel.most_common(30):
        print(f"  {us / n / 1e3:9.3f}  {calls[name] / n:6.1f} calls  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
