"""Fused GEGLU feed-forward kernel: out = (a * gelu(g)) @ w2^T + b2 with
[a | g] = x @ w1^T + b1 and exact-erf GELU.

CUDA source: `csrc/geglu_ff.cu`. It replaces
`instancediffusion_tpu/kernels/geglu_ff.py::fused_ff_geglu` (`_ff_kernel`).
The weights (up to 26 MB) stream through shared memory; each block owns 64
rows and a slice of at most 256 inner columns, keeps its bf16 a*gelu(g)
slice on chip and multiplies it into all C outputs, so no product is
computed twice and the (N, 2*inner) intermediate never reaches device
memory. The fp32 partial outputs do: with more than one slice they are
(inner/256, N, C) fp32, N*C*inner/64 bytes, written once and read once by a
second kernel that sums them. That is C/256 times the 4*N*inner bytes of
the unfused bf16 intermediate (1.25x at C=320, 2.5x at 640, 5x at 1280;
about 419 MB per call at ds1, ds2 and ds4 of the UNet's B=16 CFG batch), so
the HBM round trip the TPU kernel avoided is still there, and larger.
Whether FLOPs or these bytes bound it on the H100 is not measured. The
Pallas kernel's tanh-GELU was a Mosaic limitation;
this kernel uses erf like the model
(`instancediffusion_tpu/models/unet.py::_apply_ff_geglu`).

Weights are in torch Linear layout: w1 (2*inner, C), w2 (C, inner).
"""

from __future__ import annotations

import torch

from instancediffusion_tpu_torch.kernels import LAUNCHES
from instancediffusion_tpu_torch.kernels import _build


def ff_geglu_plain(x, w1, b1, w2, b2):
    """fp32 math, one rounding on the output."""
    h = torch.nn.functional.linear(x.float(), w1.float(), b1.float())
    a, g = h.chunk(2, dim=-1)
    ag = a * torch.nn.functional.gelu(g)
    return torch.nn.functional.linear(ag, w2.float(), b2.float()).to(x.dtype)


def fused_ff_geglu(x, w1, b1, w2, b2):
    """x (..., C) -> (..., C)."""
    if x.device.type == "cpu":
        return ff_geglu_plain(x, w1, b1, w2, b2)
    _build.require_cuda("fused_ff_geglu", x, w1, w2)
    c = x.shape[-1]
    two_inner = w1.shape[0]
    inner = two_inner // 2
    if w1.shape != (two_inner, c) or w2.shape != (c, inner) or two_inner % 2:
        raise ValueError(
            f"fused_ff_geglu: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do "
            f"not fit C={c}"
        )
    if c % 64 or inner % 64:
        raise ValueError(
            f"fused_ff_geglu: C={c} and inner={inner} must be multiples of 64"
        )
    # inner columns per block: the largest of 256, 192, 128, 64 dividing inner
    split_i = next(s for s in (256, 192, 128, 64) if inner % s == 0)
    splits = inner // split_i
    x = x.contiguous()
    w1, w2 = w1.contiguous(), w2.contiguous()
    b1 = b1.to(device=x.device, dtype=torch.float32).contiguous()
    b2 = b2.to(device=x.device, dtype=torch.float32).contiguous()
    m = x.numel() // c
    out = torch.empty_like(x)
    partial = (torch.empty((splits, m, c), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.idt_geglu_ff(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(),
            0 if partial is None else partial.data_ptr(), m, c, inner, split_i,
            _build.stream_of(x),
        )
    _build.check(err, "fused_ff_geglu")
    LAUNCHES["fused_ff_geglu"] += 1
    return out
