"""GroupNorm(+SiLU) and LayerNorm kernels over (B, N, C) activations.

CUDA source: `csrc/norms.cu`. It replaces
`instancediffusion_tpu/kernels/norms.py::fused_group_norm` (`_gn_kernel`)
and `::fused_layer_norm` (`_ln_kernel`). LayerNorm also takes fp32 rows: the
grounding tokenizer (ConvNeXt) runs in fp32, as in the JAX pipeline. Both
are bound by device-memory
bytes; the kernels read each element once for statistics and once to
normalise, with fp32 math and one rounding on store. GroupNorm splits each
sample's rows across blocks (fp64 partial sums per group), because one
block per sample would use 8-16 of the card's 132 SMs.

The plain versions compute in fp32 and round once, like the kernels, so a
kernel-vs-plain comparison measures the kernel and not two rounding choices.
"""

from __future__ import annotations

import math

import torch

from instancediffusion_tpu_torch.kernels import LAUNCHES
from instancediffusion_tpu_torch.kernels import _build

_TARGET_BLOCKS = 4 * 132  # a few waves of blocks on the H100's 132 SMs
_MAX_GROUPS = 64


def group_norm_plain(x, scale, bias, num_groups=32, eps=1e-5, act="none"):
    """x (B, N, C) -> GroupNorm over (N, C // G) per group, fp32 math."""
    b, n, c = x.shape
    xf = x.float().reshape(b, n, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, n, c)
    y = y * scale.float() + bias.float()
    if act == "silu":
        y = torch.nn.functional.silu(y)
    return y.to(x.dtype)


def layer_norm_plain(x, scale, bias, eps=1e-5):
    """Per-row LayerNorm over the last axis, fp32 math."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return y.to(x.dtype)


def _split(rows: int, blocks_per_sample: int, cap: int) -> tuple[int, int]:
    """(number of row chunks, rows per chunk) for one sample."""
    per = max(1, min(math.ceil(rows / max(1, blocks_per_sample)), cap))
    return math.ceil(rows / per), per


def _check_affine(name, x, scale, bias):
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit C={c}")


def fused_group_norm(x, scale, bias, num_groups=32, eps=1e-5, act="none"):
    """GroupNorm over (B, N, C) with an optional fused SiLU (`act="silu"`)."""
    _check_affine("fused_group_norm", x, scale, bias)
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, num_groups, eps, act)
    b, n, c = x.shape
    _build.require_cuda("fused_group_norm", x)
    if c % num_groups or c % 2 or num_groups > _MAX_GROUPS:
        raise ValueError(
            f"fused_group_norm: C={c} must be even and divisible by "
            f"G={num_groups} <= {_MAX_GROUPS}"
        )
    if act not in ("none", "silu"):
        raise ValueError(f"fused_group_norm: act={act!r}")
    x = x.contiguous()
    blocks = math.ceil(_TARGET_BLOCKS / b)
    # per-thread fp32 partial sums cover at most 512 elements
    lanes = min(c, 256)
    stat_splits, stat_rows = _split(n, blocks, 512 * (256 // lanes))
    apply_chunks, apply_rows = _split(n, 2 * blocks, n)
    scale32 = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias32 = bias.to(device=x.device, dtype=torch.float32).contiguous()
    partial = torch.empty((b, stat_splits, 2, num_groups), dtype=torch.float64,
                          device=x.device)
    y = torch.empty_like(x)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.idt_group_norm(
            x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(), y.data_ptr(),
            partial.data_ptr(), b, n, c, num_groups, stat_splits, stat_rows,
            apply_chunks, apply_rows, float(eps), int(act == "silu"),
            _build.stream_of(x),
        )
    _build.check(err, "fused_group_norm")
    LAUNCHES["fused_group_norm"] += 1
    return y


def fused_layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis of a (..., C) bf16 or fp32 tensor."""
    _check_affine("fused_layer_norm", x, scale, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    _build.require_cuda("fused_layer_norm", x,
                             dtypes=(torch.bfloat16, torch.float32))
    c = x.shape[-1]
    if c % 2:
        raise ValueError(f"fused_layer_norm: C={c} must be even")
    x = x.contiguous()
    rows = x.numel() // c
    scale32 = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias32 = bias.to(device=x.device, dtype=torch.float32).contiguous()
    y = torch.empty_like(x)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.idt_layer_norm(
            x.data_ptr(), scale32.data_ptr(), bias32.data_ptr(), y.data_ptr(),
            rows, c, float(eps), int(x.dtype == torch.float32),
            _build.stream_of(x),
        )
    _build.check(err, "fused_layer_norm")
    LAUNCHES["fused_layer_norm"] += 1
    return y
