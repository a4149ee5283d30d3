"""Time the PyTorch port's backward flash-attention kernels (dq, dk/dv) from
one checkout, for parent-against-change comparisons inside one chip call.

    python3 tools/torch_ab_backward.py --root DIR [--tag NAME]

Imports `instancediffusion_tpu_torch` and `chip_smoke` from DIR (the kernels
build into DIR/build/), then, at the training batch B=4 and each of the
training step's five long attention shapes (ds1 self 4096x4096, ds1 fuser
4096x4280, ds2 self 1024x1024, ds2 fuser 1024x1208, and the ds1 fuser under
META's labels on two of the four rows), times on one CUDA card by device
time (torch.profiler, the durations of the named kernel over 20
back-to-back calls of the public wrapper, per call; elementwise launches a
wrapper makes around the kernel are not counted): the dq kernel, the dk/dv
kernel, their sum, and SDPA's backward on the same head views (forward +
backward less forward, all kernels; a yardstick the port never calls).
Beside each: the FLOP bound (6·pairs·c and 8·pairs·c at 989 TFLOP/s, or the
operands' bytes at 3.35 TB/s if larger) and the exp2 bound (one exp2 per
kept pair, 16 per clock per SM, 132 SMs, the card's maximum SM clock).
Prints one JSON line. Run it as parent, change, change, parent in one
command. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPS = 20


def kernel_ms(torch, fn, prefix: str, reps: int = REPS) -> float:
    """Device time per call of the kernels whose names start with `prefix`."""
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
                 if e.device_type == DeviceType.CUDA and prefix in e.name
                 and not getattr(e, "is_user_annotation", False))
        if us > 0:
            return us / 1e3 / reps
    raise RuntimeError(f"kernel_ms: the profiler saw no {prefix} kernel")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    import torch.nn.functional as F

    import chip_smoke
    from instancediffusion_tpu_torch.kernels import flash_attention as fa
    from instancediffusion_tpu_torch.ops.attention import labels_to_dense

    if not torch.cuda.is_available():
        raise RuntimeError("torch_ab_backward: no CUDA device")
    dev = torch.device("cuda", 0)
    b = chip_smoke.TRAIN_B
    clock = chip_smoke.max_sm_clock_hz()
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()
    heads = lambda t, c: t.reshape(t.shape[0], t.shape[1], 8, c).transpose(1, 2)
    bits, open_ = chip_smoke.meta_labels(torch, dev, 64)
    meta = (bits.repeat_interleave(b // 2, 0), open_.repeat_interleave(b // 2, 0))
    out = {"tag": args.tag or args.root, "card": chip_smoke.card_line(),
           "max_sm_clock_mhz": clock / 1e6, "shapes": []}
    shapes = (("ds1 self", 4096, 4096, 40, False), ("ds1 fuser", 4096, 4280, 40, False),
              ("ds2 self", 1024, 1024, 80, False), ("ds2 fuser", 1024, 1208, 80, False),
              ("ds1 fuser labeled", 4096, 4280, 40, True))
    for label, n, m, c, labeled in shapes:
        q, do = heads(rnd(b, n, 8 * c), c), heads(rnd(b, n, 8 * c), c)
        k, v = heads(rnd(b, m, 8 * c), c), heads(rnd(b, m, 8 * c), c)
        labels = meta if labeled else None
        mask = labels_to_dense(*labels)[:, :, :n, :m] if labeled else None
        with torch.no_grad():
            o, lse = fa.flash_attention_fwd_lse(q, k, v, labels)
        res = (q, k, v, o, lse, do, labels)
        dq_ms = kernel_ms(torch, lambda: fa.flash_attention_bwd_dq(*res), "flash_bwd_dq")
        dkv_ms = kernel_ms(torch, lambda: fa.flash_attention_bwd_dkv(*res), "flash_bwd_dkv")
        need = [t.detach().requires_grad_(True) for t in (q, k, v)]
        fwd = lambda: F.scaled_dot_product_attention(*need, attn_mask=mask)
        sdpa_bwd = (kernel_ms(torch, lambda: fwd().backward(do), "")
                    - kernel_ms(torch, fwd, ""))
        row = {"shape": f"B={b} {label} {n}x{m} c={c}", "dq_ms": dq_ms, "dkv_ms": dkv_ms,
               "pair_ms": dq_ms + dkv_ms, "sdpa_bwd_ms": sdpa_bwd,
               "pair_over_sdpa_bwd": (dq_ms + dkv_ms) / sdpa_bwd}
        for kind, ms in (("dq", dq_ms), ("dkv", dkv_ms)):
            flops, nbytes, exps = chip_smoke._attn_work(kind, b, 8, n, m, c, mask)
            bound, by = chip_smoke._bound(flops, nbytes)
            row[f"{kind}_bound_ms"] = bound
            row[f"{kind}_bound_by"] = by
            row[f"{kind}_exp_bound_ms"] = chip_smoke._exp_bound(exps, clock)
            row[f"{kind}_share_of_bound"] = bound / ms
        out["shapes"].append(row)
        del q, k, v, do, o, lse, need, res
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
