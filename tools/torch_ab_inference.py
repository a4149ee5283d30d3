"""Time the PyTorch port's inference kernels and UNet forward from one
checkout, for parent-against-change comparisons inside one chip call.

    python3 tools/torch_ab_inference.py --root DIR [--tag NAME]

Imports `instancediffusion_tpu_torch` and `chip_smoke` from DIR (the
kernels build into DIR/build/), then times on one CUDA card: the split-heads
flash kernel at (2,8,4096,40) self and over 4280 fuser keys, its labeled
instantiation over 4280 keys with META's box labels, the packed kernel at
(2,1024,8*80) self (each the mean of 50 launches after 10 warm-up
launches, CUDA events), and the full-width B=16 gate-1 UNet forward on
densified random weights (median of 10). Prints one JSON line. Run it as
parent, change, change, parent in one command. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def mean_ms(torch, fn, warm: int = 10, reps: int = 50) -> float:
    for _ in range(warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    import chip_smoke
    from instancediffusion_tpu_torch.config import Config, apply_test_preset
    from instancediffusion_tpu_torch.kernels import flash_attention as fa
    from instancediffusion_tpu_torch.models import unet as unet_lib

    if not torch.cuda.is_available():
        raise RuntimeError("torch_ab_inference: no CUDA device")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()
    heads = lambda t, c: t.reshape(t.shape[0], t.shape[1], 8, c).transpose(1, 2)
    q, k = heads(rnd(2, 4096, 320), 40), heads(rnd(2, 4280, 320), 40)
    labels = chip_smoke.meta_labels(torch, dev, 64)
    p = rnd(2, 1024, 640)
    out = {"tag": args.tag or args.root, "card": chip_smoke.card_line()}
    with torch.inference_mode():
        out["k1_self_ms"] = mean_ms(torch, lambda: fa.flash_attention(q, q, q))
        out["k1_fuser_ms"] = mean_ms(torch, lambda: fa.flash_attention(q, k, k))
        out["k1l_fuser_ms"] = mean_ms(torch, lambda: fa.flash_attention(q, k, k, labels=labels))
        out["k2_self_ms"] = mean_ms(torch, lambda: fa.flash_attention_packed(p, p, p, 8))

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
        out["unet_b16_gate1_ms"] = chip_smoke.median_ms(fwd, reps=10)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
