"""Time the PyTorch port's attention and GroupNorm kernels and its UNet
forward from one checkout, for parent-against-change comparisons inside one
chip call.

    python3 tools/torch_ab_inference.py --root DIR [--tag NAME]

Imports `instancediffusion_tpu_torch` and `chip_smoke` from DIR (the
kernels build into DIR/build/), then times on one CUDA card, each by device
time (the durations of every kernel that 20 back-to-back calls launch, from
torch.profiler, per call): the split-heads flash kernel at the UNet's B=16
(ds1 self, the 4280-key fuser, 4608 keys with kv_len 4280, and labeled with
META's boxes on the 8 conditional rows; SDPA on the same self and fuser
views as a yardstick), the packed kernel at B=16 (ds2
self and the 1208-key fuser), the training forward with log-sum-exp at B=4
(ds1 and ds2, self and fuser), GroupNorm at every shape of the B=16 UNet
forward and of the VAE decoder at B=8; LayerNorm at the six row shapes of
that forward beside F.layer_norm; the GEGLU feed-forward as the UNet calls it
at the four levels' B=16 shapes (`ff_geglu` where the checkout has the switch,
else `fused_ff_geglu`) beside the unfused three-call bf16 route; then the
full-width B=16 gate-1 UNet forward on densified random weights (median of
10, CUDA events), and with --profile the device time of one such forward by
kernel (torch.profiler; the 25 largest and the busy share). The fused
projection kernels (K8 proj_split, K8' merge_proj) at the four B=16 cases of
the ds1 attentions, each beside its F.linear yardstick, and the B=16
forward's device time with FUSED_PROJ on and off; `--head-layout` times
only those. Prints one JSON line. Run it as parent, change, change, parent
in one command. Imports no JAX.

    python3 tools/torch_ab_inference.py --root DIR --head-layout
    python3 tools/torch_ab_inference.py --root DIR --attention

`--attention` times only the forward attention kernels by device time: K1
(ds1 self and fuser), K2 and K6 unlabeled, and the labeled kernel (K1-L) at
B=16 with META's boxes on the 8 conditional rows, at the B=80 masked MIS
call with META's boxes and with the layouts
the benchmark's gen cell draws for requests 0-2 of seed 2147483659
(`port_bench.harness.layouts`), and K6-L at B=4; each labeled case with its
kept-pair exp2 bound and, where the checkout counts them, the share of key
tiles its tile plans listed. The B=80 labels come from
`chip_smoke.mis_mix_labels`, so `--attention` needs a checkout that has it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPS = 20
# (rows, C, eps, act) of the B=16 gate-1 UNet forward and the VAE decoder at B=8
GN_UNET_B16 = ((4096, 320, 1e-5, "silu"), (4096, 320, 1e-6, "none"), (4096, 640, 1e-5, "silu"),
               (4096, 960, 1e-5, "silu"), (1024, 320, 1e-5, "silu"), (1024, 640, 1e-5, "silu"),
               (1024, 640, 1e-6, "none"), (1024, 960, 1e-5, "silu"), (1024, 1280, 1e-5, "silu"),
               (1024, 1920, 1e-5, "silu"), (256, 640, 1e-5, "silu"), (256, 1280, 1e-5, "silu"),
               (256, 1280, 1e-6, "none"), (256, 1920, 1e-5, "silu"), (256, 2560, 1e-5, "silu"),
               (64, 1280, 1e-5, "silu"), (64, 1280, 1e-6, "none"), (64, 2560, 1e-5, "silu"))
GN_VAE_B8 = ((4096, 512, 1e-6, "silu"), (4096, 512, 1e-6, "none"), (16384, 512, 1e-6, "silu"),
             (65536, 256, 1e-6, "silu"), (65536, 512, 1e-6, "silu"), (262144, 128, 1e-6, "silu"),
             (262144, 256, 1e-6, "silu"))


def device_ms(torch, fn, reps: int = REPS) -> float:
    """Summed device durations of the kernels `reps` calls launch, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # CUPTI now and then delivers no kernel record: measure again
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


LN_UNET_B16 = ((4096, 320), (4280, 320), (1024, 640), (1208, 640), (256, 1280), (440, 1280))
FF_UNET_B16 = (("ds1", 4096, 320), ("ds2", 1024, 640), ("ds4", 256, 1280), ("ds8", 64, 1280))


def forward_profile(torch, fwd, top: int = 25) -> dict:
    """Device time of one forward by kernel name, and the busy share of the
    window (device time over the host's wall time of the same forwards)."""
    import time

    from torch.profiler import ProfilerActivity, profile

    fwd()
    torch.cuda.synchronize()
    reps = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = sorted(((e.device_time_total / 1e3 / reps, e.count // reps, e.key)
                   for e in prof.key_averages() if e.device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows)
    return {"forward_device_ms": total, "forward_wall_ms": wall_ms,
            "busy_share": total / wall_ms,
            "kernels": [{"ms": round(ms, 4), "calls": n, "name": name[:90]}
                        for ms, n, name in rows[:top]]}


def head_layout_cases(torch, rnd):
    """(name, kernel call, library call) of K8 / K8' at the B=16 shapes of
    the ds1 attentions on the FUSED_PROJ route: q from a row slice of the
    fuser's (16,4280,320) [x | objs], k and v over the self-attention's 4096
    rows and over the fuser's 4280 (written padded to 4288), merge_proj on
    the flash kernel's output view with the fp32 bias. Library: F.linear of
    the same product without the relayout (k and v: one call over the
    concatenated weights)."""
    from instancediffusion_tpu_torch.kernels import head_layout as hl

    F = torch.nn.functional
    w = lambda: rnd(320, 320) * 320 ** -0.5
    cat, xs = rnd(16, 4280, 320), rnd(16, 4096, 320)
    cases = []
    for name, x, n_w in (("q", cat[:, :4096], 1), ("kv_self", xs, 2), ("kv_fuser", cat, 2)):
        ws = [w() for _ in range(n_w)]
        wcat = torch.cat(ws)
        cases.append((f"k8_b16_{name}", lambda x=x, ws=ws: hl.proj_split(x, ws, 8),
                      lambda x=x, wcat=wcat: F.linear(x, wcat)))
    o = rnd(16, 4096, 8, 40).permute(0, 2, 1, 3)
    wo, bo = w(), torch.randn(320, device=o.device) * 0.1
    cases.append(("k8m_b16_flash_view", lambda: hl.merge_proj(o, wo, bo),
                  lambda: F.linear(o.transpose(1, 2).reshape(16, 4096, 320), wo,
                                   bo.to(wo.dtype))))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--head-layout", action="store_true",
                    help="time only K8 / K8' and the FUSED_PROJ forward A/B")
    ap.add_argument("--attention", action="store_true",
                    help="time only the forward attention kernels, labeled and not")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    import chip_smoke
    from instancediffusion_tpu_torch.config import Config, apply_test_preset
    from instancediffusion_tpu_torch.models import unet as unet_lib

    if not torch.cuda.is_available():
        raise RuntimeError("torch_ab_inference: no CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()
    out = {"tag": args.tag or args.root, "card": chip_smoke.card_line()}
    if args.attention:
        with torch.inference_mode():
            time_attention(torch, dev, rnd, out)
        print(json.dumps(out), flush=True)
        return 0
    with torch.inference_mode():
        for name, kern, lib in head_layout_cases(torch, rnd):
            out[f"{name}_ms"] = device_ms(torch, kern)
            out[f"{name}_linear_ms"] = device_ms(torch, lib)
        if not args.head_layout:
            time_kernels(torch, dev, g, rnd, out)
        cfg = apply_test_preset(Config(), "box").model
        gen = torch.Generator(device=dev).manual_seed(0)
        model = unet_lib.UNet(cfg, generator=gen, device=dev).to(torch.bfloat16).eval()
        chip_smoke.densify_(model, 1)
        x = torch.randn((16, 64, 64, 4), generator=g, device=dev).bfloat16()
        ctx = rnd(16, 77, 768)
        objs = torch.randn((16, 184, 768), generator=g, device=dev)
        t = torch.full((16,), 981, device=dev)
        fwd = lambda: unet_lib.apply_unet(model, cfg, x, t, ctx, gate_scale=1.0,
                                          precomputed_objs=objs)
        if not args.head_layout:
            out["unet_b16_gate1_ms"] = chip_smoke.median_ms(fwd, reps=10)
            if args.profile:
                out["profile"] = forward_profile(torch, fwd)
        for fused in (False, True, True, False):
            unet_lib.FUSED_PROJ = fused
            key = f"unet_b16_gate1_device_ms_fused_{'on' if fused else 'off'}"
            out.setdefault(key, []).append(device_ms(torch, fwd, reps=5))
        unet_lib.FUSED_PROJ = False
    print(json.dumps(out), flush=True)
    return 0


def time_attention(torch, dev, rnd, out) -> None:
    """The forward attention kernels, labeled and not (see the module
    docstring); kept pairs from labels_to_dense in slices of 8 rows."""
    import chip_smoke
    from instancediffusion_tpu_torch import kernels
    from instancediffusion_tpu_torch.kernels import flash_attention as fa
    from instancediffusion_tpu_torch.ops.attention import labels_to_dense
    from port_bench.harness import layouts

    heads = lambda t, c: t.reshape(t.shape[0], t.shape[1], 8, c).transpose(1, 2)
    clock = chip_smoke.max_sm_clock_hz()
    share = getattr(fa, "label_tile_share", None)

    def labeled(key, q, k, v, labels, lse=False):
        n, m = q.shape[2], k.shape[2]
        kept = sum(int(labels_to_dense(labels[0][r:r + 8], labels[1][r:r + 8])
                       [:, :, :n, :m].sum()) for r in range(0, labels[0].shape[0], 8))
        call = ((lambda: fa.flash_attention_fwd_lse(q, k, v, labels)) if lse
                else (lambda: fa.flash_attention(q, k, v, labels=labels)))
        out[f"{key}_ms"] = device_ms(torch, call)
        out[f"{key}_exp_bound_ms"] = chip_smoke._exp_bound(8 * kept, clock)
        if share is not None:
            kernels.reset_launch_counts()
            call()
            listed, total = share()
            out[f"{key}_tile_share"] = listed / total

    q, k = heads(rnd(16, 4096, 320), 40), heads(rnd(16, 4280, 320), 40)
    out["k1_b16_self_ms"] = device_ms(torch, lambda: fa.flash_attention(q, q, q))
    out["k1_b16_fuser_ms"] = device_ms(torch, lambda: fa.flash_attention(q, k, k))
    bits, open_ = chip_smoke.meta_labels(torch, dev, 64)
    labeled("k1l_b16_meta", q, k, k,
            (bits.repeat_interleave(8, 0), open_.repeat_interleave(8, 0)))
    q80, k80 = heads(rnd(80, 4096, 320), 40), heads(rnd(80, 4280, 320), 40)
    out["k1_b80_fuser_ms"] = device_ms(torch, lambda: fa.flash_attention(q80, k80, k80))
    labeled("k1l_b80_meta_mix", q80, k80, k80, chip_smoke.mis_mix_labels(torch, dev))
    for r in range(3):  # the gen cell's requests 0-2 at seed 2147483659
        four = layouts.layout(layouts.rng(2147483659, 1, r), 4)["locations"]
        labeled(f"k1l_b80_cell_r{r}", q80, k80, k80, chip_smoke.mis_mix_labels(torch, dev, four))
    del q80, k80
    p, pk = rnd(16, 1024, 640), rnd(16, 1208, 640)
    out["k2_b16_self_ms"] = device_ms(torch, lambda: fa.flash_attention_packed(p, p, p, 8))
    out["k2_b16_fuser_ms"] = device_ms(torch, lambda: fa.flash_attention_packed(p, pk, pk, 8))
    tq, tk = heads(rnd(4, 4096, 320), 40), heads(rnd(4, 4280, 320), 40)
    out["k6_b4_ds1_fuser_ms"] = device_ms(torch, lambda: fa.flash_attention_fwd_lse(tq, tk, tk))
    labeled("k6l_b4_meta", tq, tk, tk,
            (bits.repeat_interleave(2, 0), open_.repeat_interleave(2, 0)), lse=True)


def time_kernels(torch, dev, g, rnd, out) -> None:
    """K1-K6 at the paths' batches (see the module docstring)."""
    import chip_smoke
    from instancediffusion_tpu_torch.kernels import flash_attention as fa
    from instancediffusion_tpu_torch.kernels import geglu_ff as ff
    from instancediffusion_tpu_torch.kernels import norms

    heads = lambda t, c: t.reshape(t.shape[0], t.shape[1], 8, c).transpose(1, 2)
    q, k = heads(rnd(16, 4096, 320), 40), heads(rnd(16, 4608, 320), 40)
    bits, open_ = chip_smoke.meta_labels(torch, dev, 64)
    labels = (bits.repeat_interleave(8, 0), open_.repeat_interleave(8, 0))
    out["k1_b16_self_ms"] = device_ms(torch, lambda: fa.flash_attention(q, q, q))
    out["k1_b16_fuser_ms"] = device_ms(
        torch, lambda: fa.flash_attention(q, k[:, :, :4280], k[:, :, :4280]))
    out["k1_b16_fuser_kv_len_ms"] = device_ms(
        torch, lambda: fa.flash_attention(q, k, k, kv_len=4280))
    out["k1l_b16_fuser_ms"] = device_ms(
        torch, lambda: fa.flash_attention(q, k[:, :, :4280], k[:, :, :4280], labels=labels))
    # the yardstick, PyTorch's SDPA on the same head views (never called by the port)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out["sdpa_b16_self_ms"] = device_ms(torch, lambda: sdpa(q, q, q))
    out["sdpa_b16_fuser_ms"] = device_ms(
        torch, lambda: sdpa(q, k[:, :, :4280], k[:, :, :4280]))
    p, pk = rnd(16, 1024, 640), rnd(16, 1208, 640)
    out["k2_b16_self_ms"] = device_ms(torch, lambda: fa.flash_attention_packed(p, p, p, 8))
    out["k2_b16_fuser_ms"] = device_ms(torch, lambda: fa.flash_attention_packed(p, pk, pk, 8))
    for name, n, m, c in (("ds1_self", 4096, 4096, 40), ("ds1_fuser", 4096, 4280, 40),
                          ("ds2_self", 1024, 1024, 80), ("ds2_fuser", 1024, 1208, 80)):
        tq, tk = heads(rnd(4, n, 8 * c), c), heads(rnd(4, m, 8 * c), c)
        out[f"k6_b4_{name}_ms"] = device_ms(
            torch, lambda tq=tq, tk=tk: fa.flash_attention_fwd_lse(tq, tk, tk))
    for b, shapes in ((16, GN_UNET_B16), (8, GN_VAE_B8)):
        for n, c, eps, act in shapes:
            x = (torch.randn((b, n, c), generator=g, device=dev) * 3 + 0.5).bfloat16()
            sc, bi = rnd(c), rnd(c)
            out[f"k3_{b}x{n}x{c}_{act}_ms"] = device_ms(
                torch, lambda x=x, sc=sc, bi=bi, e=eps, a=act:
                norms.fused_group_norm(x, sc, bi, 32, e, a))
            del x

    F = torch.nn.functional
    for n, c in LN_UNET_B16:
        x = (torch.randn((16, n, c), generator=g, device=dev) * 2 + 0.3).bfloat16()
        sc, bi = rnd(c), rnd(c)
        out[f"k4_16x{n}x{c}_ms"] = device_ms(
            torch, lambda x=x, sc=sc, bi=bi: norms.fused_layer_norm(x, sc, bi, 1e-5))
        out[f"layer_norm_16x{n}x{c}_ms"] = device_ms(
            torch, lambda x=x, sc=sc, bi=bi: F.layer_norm(x, (x.shape[-1],), sc, bi, 1e-5))
    ff_call = getattr(ff, "ff_geglu", ff.fused_ff_geglu)

    def unfused(x, w1, b1, w2, b2):
        a, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
        return F.linear(a * F.gelu(gate), w2, b2)

    for name, n, c in FF_UNET_B16:
        inner = 4 * c
        a = (rnd(16, n, c), rnd(2 * inner, c) * c ** -0.5, rnd(2 * inner) * 0.1,
             rnd(c, inner) * inner ** -0.5, rnd(c) * 0.1)
        out[f"k5_b16_{name}_ms"] = device_ms(torch, lambda a=a: ff_call(*a))
        out[f"ff_unfused_b16_{name}_ms"] = device_ms(torch, lambda a=a: unfused(*a))
        del a


if __name__ == "__main__":
    sys.exit(main())
