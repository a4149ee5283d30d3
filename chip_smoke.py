"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, in order (each prints its lines; any failure exits non-zero):
  device     require CUDA; print the card's name and power limit (nvidia-smi)
  build      build the hand-written kernels from csrc/ with nvcc
  kernels    each kernel against its plain PyTorch version at the main path's
             per-sample shapes (batch 2), in bf16 (LayerNorm also on the fp32
             ConvNeXt rows): max abs / relative error against the stated
             tolerance, median kernel and plain times
  grounding  UniFusion in fp32 (ConvNeXt's LayerNorms through the kernel) on
             the slice's layout with random phrase embeddings and instance
             masks, seg tokens kept, kernels vs plain_kernels()
  unet       one full-width UNet forward (B=2, gate 1.0, those 184 grounding
             tokens) on densified random weights, kernels vs plain_kernels()
  slice      random_init + densify + generate (8 images, 50-step PLMS, 4
             instances, mis=0, bf16): warm-up, then timed requests; checks the
             output and that every kernel launched during the timed run
Then the card's nvidia-smi line, one JSON line describing the kernels and,
last, the device line {"ok": true, "device": {...}}.

Weights are random (seeded); the hash tokenizer stands in for CLIP's BPE
files. nvcc's log (with -Xptxas -v register counts) is written beside the
built library, in build/instancediffusion_tpu_torch/<hash>/build.log.
"""

from __future__ import annotations

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

# where each kernel lives and which TPU kernel it replaces
KERNELS = {
    "flash_attention": (
        "cuda", "instancediffusion_tpu_torch/csrc/flash_attention.cu",
        "instancediffusion_tpu/kernels/flash_attention.py:213"),
    "flash_attention_packed": (
        "cuda", "instancediffusion_tpu_torch/csrc/flash_attention.cu",
        "instancediffusion_tpu/kernels/flash_attention.py:448"),
    "fused_group_norm": (
        "cuda", "instancediffusion_tpu_torch/csrc/norms.cu",
        "instancediffusion_tpu/kernels/norms.py:125"),
    "fused_layer_norm": (
        "cuda", "instancediffusion_tpu_torch/csrc/norms.cu",
        "instancediffusion_tpu/kernels/norms.py:210"),
    "fused_ff_geglu": (
        "cuda", "instancediffusion_tpu_torch/csrc/geglu_ff.cu",
        "instancediffusion_tpu/kernels/geglu_ff.py:63"),
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


# ---------------------------------------------------------------------------
# kernels vs plain
# ---------------------------------------------------------------------------


def _cases(torch, dev):
    """(kernel name, label, kernel fn, plain fn, tolerance) at the main
    path's per-sample shapes, batch 2."""
    from instancediffusion_tpu_torch.kernels import flash_attention as fa
    from instancediffusion_tpu_torch.kernels import geglu_ff as ff
    from instancediffusion_tpu_torch.kernels import norms
    from instancediffusion_tpu_torch.ops.attention import sdpa_xla

    g = torch.Generator(device=dev).manual_seed(0)
    bf, fp = torch.bfloat16, torch.float32

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * std).to(dtype)

    cases = []
    # split-heads attention at ds1 (c=40): head views of (B,N,H*c)
    # projections, as the UNet passes them; fuser over the unpadded 4280
    # keys and over 4608 pre-padded keys with kv_len=4280
    for label, n, m, kv_len in (("self 4096x4096", 4096, 4096, None),
                                ("fuser 4096x4280", 4096, 4280, None),
                                ("fuser 4096x4608 kv_len=4280", 4096, 4608, 4280)):
        q, k, v = randn(2, n, 320), randn(2, m, 320), randn(2, m, 320)
        heads = lambda t: t.reshape(2, t.shape[1], 8, 40).transpose(1, 2)
        qh, kh, vh = heads(q), heads(k), heads(v)
        mm = m if kv_len is None else kv_len
        cases.append((
            "flash_attention", label,
            lambda qh=qh, kh=kh, vh=vh, kv=kv_len: fa.flash_attention(qh, kh, vh, kv_len=kv),
            lambda qh=qh, kh=kh, vh=vh, mm=mm: sdpa_xla(qh, kh[:, :, :mm], vh[:, :, :mm]),
            BF16_REL_TOL,
        ))
    # packed attention at ds2 (c=80)
    for label, n, m, kv_len in (("self 1024x1024", 1024, 1024, None),
                                ("fuser 1024x1208", 1024, 1208, None),
                                ("fuser 1024x1536 kv_len=1208", 1024, 1536, 1208)):
        q, k, v = randn(2, n, 640), randn(2, m, 640), randn(2, m, 640)
        mm = m if kv_len is None else kv_len

        def plain(q=q, k=k, v=v, mm=mm):
            heads = lambda t: t.reshape(2, t.shape[1], 8, 80).transpose(1, 2)
            out = sdpa_xla(heads(q), heads(k[:, :mm]), heads(v[:, :mm]))
            return out.transpose(1, 2).reshape(2, q.shape[1], 640)

        cases.append((
            "flash_attention_packed", label,
            lambda q=q, k=k, v=v, kv=kv_len: fa.flash_attention_packed(q, k, v, 8, kv_len=kv),
            plain, BF16_REL_TOL,
        ))
    # GroupNorm: UNet (eps 1e-5 res/out with SiLU, 1e-6 transformer) and
    # VAE decoder rows (eps 1e-6)
    for n, c, eps, act in ((4096, 320, 1e-5, "silu"), (4096, 320, 1e-6, "none"),
                           (4096, 960, 1e-5, "silu"), (1024, 640, 1e-5, "silu"),
                           (256, 1280, 1e-5, "silu"), (64, 2560, 1e-5, "silu"),
                           (262144, 128, 1e-6, "silu"), (65536, 256, 1e-6, "silu"),
                           (4096, 512, 1e-6, "none")):
        x = randn(2, n, c, std=3.0) + 0.5
        sc, bi = randn(c), randn(c)
        cases.append((
            "fused_group_norm", f"({n},{c}) eps={eps} {act}",
            lambda x=x, sc=sc, bi=bi, e=eps, a=act: norms.fused_group_norm(x, sc, bi, 32, e, a),
            lambda x=x, sc=sc, bi=bi, e=eps, a=act: norms.group_norm_plain(x, sc, bi, 32, e, a),
            BF16_REL_TOL,
        ))
    # LayerNorm: bf16 UNet rows incl. fuser concat rows and CLIP; fp32
    # ConvNeXt rows (the grounding tokenizer runs in fp32, at batch 1)
    for n, c, eps, dt in ((4096, 320, 1e-5, bf), (4280, 320, 1e-5, bf),
                          (1208, 640, 1e-5, bf), (256, 1280, 1e-5, bf),
                          (440, 1280, 1e-5, bf), (77, 768, 1e-5, bf),
                          (16384, 96, 1e-6, fp), (4096, 192, 1e-6, fp),
                          (1024, 384, 1e-6, fp), (256, 768, 1e-6, fp)):
        x = (randn(2, n, c, std=2.0, dtype=dt) + 0.3).to(dt)
        sc, bi = randn(c), randn(c)
        cases.append((
            "fused_layer_norm", f"({n},{c}) eps={eps} {str(dt)[6:]}",
            lambda x=x, sc=sc, bi=bi, e=eps: norms.fused_layer_norm(x, sc, bi, e),
            lambda x=x, sc=sc, bi=bi, e=eps: norms.layer_norm_plain(x, sc, bi, e),
            BF16_REL_TOL if dt == bf else FP32_REL_TOL,
        ))
    # GEGLU FF at the three transformer widths (ds8 mid block too)
    for n, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)):
        inner = 4 * c
        x = randn(2, n, c)
        w1, b1 = randn(2 * inner, c, std=c ** -0.5), randn(2 * inner, std=0.1)
        w2, b2 = randn(c, inner, std=inner ** -0.5), randn(c, std=0.1)
        cases.append((
            "fused_ff_geglu", f"({n},{c}) inner={inner}",
            lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: ff.fused_ff_geglu(x, w1, b1, w2, b2),
            lambda x=x, w1=w1, b1=b1, w2=w2, b2=b2: ff.ff_geglu_plain(x, w1, b1, w2, b2),
            BF16_REL_TOL,
        ))
    return cases


def phase_kernels(torch, dev) -> dict:
    """Compare every kernel with its plain version and time both (median of
    10 runs, CUDA events) at every case."""
    results = {}
    failures = []
    for name, label, kern, plain, tol in _cases(torch, dev):
        out = kern()
        ref = plain()
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out.float()).all():
            failures.append(f"{name} {label}: shape {tuple(out.shape)} vs "
                            f"{tuple(ref.shape)} or non-finite output")
            continue
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / max(ref.float().abs().max().item(), 1e-12)
        ok = rel <= tol
        entry = results.setdefault(name, {"max_abs_err": 0.0, "max_rel_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["max_rel_err"] = max(entry["max_rel_err"], rel)
        ms, plain_ms = median_ms(kern), median_ms(plain)
        if "ms" not in entry:  # the JSON line reports each kernel's first case
            entry["ms"], entry["plain_ms"] = ms, plain_ms
        log(f"kernels: {name} {label}: max_abs_err={err:.4g} rel={rel:.3g} "
            f"tol={tol:g} {'ok' if ok else 'FAIL'} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f}")
        if not ok:
            failures.append(f"{name} {label}: rel err {rel:.3g} > {tol:g}")
        del out, ref
    if failures:
        raise RuntimeError("kernel checks failed:\n  " + "\n  ".join(failures))
    return results


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


def phase_unet(torch, dev, cfg, unet_mod, objs1) -> str:
    """objs1: the (1, G, 768) fp32 grounding tokens of the grounding phase."""
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
    with torch.inference_mode():
        run = lambda: unet_lib.apply_unet(unet_mod, mc, x, t, ctx, None, gate_scale=1.0,
                                          precomputed_objs=objs)
        eps_k = run()
        with plain_kernels():
            eps_p = run()
        torch.cuda.synchronize()
        ms_k = median_ms(run, reps=5)
        with plain_kernels():
            ms_p = median_ms(run, reps=5)
    if eps_k.shape != x.shape or not torch.isfinite(eps_k.float()).all():
        raise RuntimeError(f"unet: bad eps {tuple(eps_k.shape)}")
    err = (eps_k.float() - eps_p.float()).abs().max().item()
    scale = eps_p.float().abs().max().item()
    rel = err / max(scale, 1e-12)
    if scale == 0.0 or rel > UNET_REL_TOL:
        raise RuntimeError(f"unet: kernels vs plain rel err {rel:.3g} "
                           f"(max |eps| {scale:.3g}) > {UNET_REL_TOL}")
    return (f"unet: B=2 gate=1.0 tokens={n_tok} max_abs_err={err:.4g} "
            f"max|eps|={scale:.4g} rel={rel:.3g} tol={UNET_REL_TOL} "
            f"kernel_fwd_ms={ms_k:.2f} plain_fwd_ms={ms_p:.2f}")


# ---------------------------------------------------------------------------
# slice
# ---------------------------------------------------------------------------


def phase_slice(torch, pipe, card: str) -> tuple[str, dict]:
    import numpy as np

    from instancediffusion_tpu_torch import kernels

    n_img = N_IMAGES
    t0 = time.perf_counter()
    imgs = pipe.generate(META, num_images=n_img, steps=STEPS, mis=0.0, seed=0)
    warm_s = time.perf_counter() - t0
    kernels.reset_launch_counts()
    times = []
    for seed in (1, 2):
        t0 = time.perf_counter()
        imgs = pipe.generate(META, num_images=n_img, steps=STEPS, mis=0.0, seed=seed)
        times.append(time.perf_counter() - t0)
    launches = dict(kernels.LAUNCHES)
    size = pipe.image_size
    if imgs.shape != (n_img, size, size, 3) or imgs.dtype != np.uint8:
        raise RuntimeError(f"slice: images {imgs.shape} {imgs.dtype}")
    if int(imgs.max()) == int(imgs.min()):
        raise RuntimeError("slice: constant images")
    missing = [k for k in KERNELS if launches.get(k, 0) <= 0]
    if missing:
        raise RuntimeError(f"slice: kernels never launched: {missing} ({launches})")
    s_img = min(times) / n_img
    line = (f"slice: generate B={n_img} steps={STEPS} PLMS mis=0 bf16: "
            f"warm-up {warm_s:.2f}s, requests {', '.join(f'{t:.3f}s' for t in times)}, "
            f"{s_img:.4f} s/image on {card}; launches {launches}")
    return line, launches


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
    cfg = apply_test_preset(Config(), "box")
    t0 = time.perf_counter()
    pipe = InstanceDiffusionPipeline.random_init(cfg, seed=0, device=dev)
    densify_(pipe.unet, 1)
    densify_(pipe.vae, 2)
    densify_(pipe.clip, 3)
    torch.cuda.synchronize()
    log(f"init: random_init + densify {time.perf_counter() - t0:.1f}s")
    line, objs = phase_grounding(torch, dev, cfg, pipe.unet)
    log(line)
    log(phase_unet(torch, dev, cfg, pipe.unet, objs))
    line, launches = phase_slice(torch, pipe, card)
    log(line)

    kernels_json = []
    for name, (route, source, replaces) in KERNELS.items():
        r = results[name]
        kernels_json.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels_json}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
