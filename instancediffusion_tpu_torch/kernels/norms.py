"""GroupNorm(+SiLU) and LayerNorm kernels over (B, N, C) activations.

CUDA source: `csrc/norms.cu`. It replaces
`instancediffusion_tpu/kernels/norms.py::fused_group_norm` (`_gn_kernel`)
and `::fused_layer_norm` (`_ln_kernel`). LayerNorm also takes fp32 rows: the
grounding tokenizer (ConvNeXt) runs in fp32, as in the JAX pipeline. Both
are bound by device-memory bytes.

GroupNorm is one cooperative launch with the affine as the module keeps it
(bf16 or fp32), 16-byte loads and a deterministic combine: each block sums
its rows, a grid barrier, then each block normalises its rows walking them
in reverse, so part of that second read comes from L2. `gn_plan` cuts the
rows by shape, and a batch too large for one resident grid into several
launches over batch chunks. LayerNorm reads each row once: 8, 16 or 32 lanes
share a row (`ln_plan`), hold it in registers between the fp32 statistics
and the normalise, and round once on store; the affine is read as stored.

The plain versions compute in fp32 and round once, like the kernels, so a
kernel-vs-plain comparison measures the kernel and not two rounding choices.
Under autograd the kernels' gradient is autograd of the plain version,
recomputed from the saved inputs (`_vjp.py`), as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from instancediffusion_tpu_torch.kernels import LAUNCHES
from instancediffusion_tpu_torch.kernels import _build
from instancediffusion_tpu_torch.kernels._vjp import plain_vjp

_MAX_GROUPS = 64
GN_MAX_THREADS = 320  # one thread per 8-channel vector of a row: C <= 2560
GN_COOP_BLOCKS_PER_SM = 4  # kCoopBlocksPerSM in csrc/norms.cu: all blocks resident


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


class GnPlan(NamedTuple):
    """How `fused_group_norm` covers one (B, N, C) call: each sample's rows
    in `splits` chunks, chunk i holding rows [i * rows_per, min(N, (i + 1) *
    rows_per)); threads per block; dynamic shared memory bytes; samples per
    cooperative launch (launch j takes samples [j * batch_chunk, min(B, (j +
    1) * batch_chunk)), a grid of splits x that many blocks)."""
    splits: int
    rows_per: int
    threads: int
    smem: int
    batch_chunk: int

    def launches(self, b: int) -> list[tuple[int, int]]:
        """(first sample, samples) of each launch over a batch of b."""
        return [(s, min(self.batch_chunk, b - s)) for s in range(0, b, self.batch_chunk)]


def gn_plan(b: int, n: int, c: int, sm_count: int) -> GnPlan:
    """Grid and shared memory of one GroupNorm call: one thread per 8-channel
    vector of a row times the rows a block takes at once, and each sample's
    rows split over at most GN_COOP_BLOCKS_PER_SM blocks per SM in all, so
    the whole grid is resident for its barrier. A batch above that many
    blocks is cut into the fewest equal launches that are each resident."""
    if c % 8 or c // 8 > GN_MAX_THREADS:
        raise ValueError(f"gn_plan: C={c} must be a multiple of 8 <= {8 * GN_MAX_THREADS}")
    lanes = c // 8
    threads = lanes * max(1, 256 // lanes)
    total = sm_count * GN_COOP_BLOCKS_PER_SM
    chunk = -(-b // -(-b // total))
    rows_per = -(-n // max(1, total // chunk))
    return GnPlan(-(-n // rows_per), rows_per, threads, threads * 8 * 4, chunk)


LN_MAX_VECS = 8  # kLnVecs in csrc/norms.cu: 16-byte vectors of a row per lane


def ln_plan(c: int, elem_bytes: int) -> int:
    """Lanes that share one LayerNorm row on the register-resident route:
    the fewest of 8, 16, 32 that hold the row's 16-byte vectors at no more
    than 5 a lane (so narrow rows go several to a warp), else the fewest
    that hold it at LN_MAX_VECS; 0 when C is off the vector size or too
    wide, which takes the generic loop."""
    per_vec = 16 // elem_bytes
    if c % per_vec:
        return 0
    vecs = c // per_vec
    for most in (5, LN_MAX_VECS):
        for lanes in (8, 16, 32):
            if vecs <= lanes * most:
                return lanes
    return 0


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_affine(name, x, scale, bias):
    c = x.shape[-1]
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{name}: scale {tuple(scale.shape)} / bias "
                         f"{tuple(bias.shape)} do not fit C={c}")


def _kernel_affine(x, scale, bias):
    """scale and bias as the kernels read them: on x's device, contiguous,
    both bf16 or both fp32. Parameters kept that way (every module's) pass
    through untouched, so a call costs no cast."""
    if scale.dtype != bias.dtype or scale.dtype not in (torch.bfloat16, torch.float32):
        scale, bias = scale.float(), bias.float()
    return scale.to(x.device).contiguous(), bias.to(x.device).contiguous()


def fused_group_norm(x, scale, bias, num_groups=32, eps=1e-5, act="none"):
    """GroupNorm over (B, N, C) with an optional fused SiLU (`act="silu"`)."""
    _check_affine("fused_group_norm", x, scale, bias)
    if x.device.type == "cpu":
        return group_norm_plain(x, scale, bias, num_groups, eps, act)
    kw = dict(num_groups=num_groups, eps=eps, act=act)
    return plain_vjp(functools.partial(_group_norm_kernel, **kw),
                     functools.partial(group_norm_plain, **kw), x, scale, bias)


def _group_norm_kernel(x, scale, bias, num_groups, eps, act):
    b, n, c = x.shape
    _build.require_cuda("fused_group_norm", x)
    if c % num_groups or c % 8 or num_groups > _MAX_GROUPS:
        raise ValueError(
            f"fused_group_norm: C={c} must be a multiple of 8 and divisible by "
            f"G={num_groups} <= {_MAX_GROUPS}"
        )
    if act not in ("none", "silu"):
        raise ValueError(f"fused_group_norm: act={act!r}")
    x = x.contiguous()
    scale, bias = _kernel_affine(x, scale, bias)
    plan = gn_plan(b, n, c, _sm_count(x.device.index))
    partial = torch.empty((b, plan.splits, 2, num_groups), dtype=torch.float64,
                          device=x.device)
    y = torch.empty_like(x)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        for first, count in plan.launches(b):
            err = lib.idt_group_norm(
                x[first:].data_ptr(), scale.data_ptr(), bias.data_ptr(), y[first:].data_ptr(),
                partial[first:].data_ptr(), count, n, c, num_groups, plan.splits,
                plan.rows_per, plan.threads, plan.smem, float(eps), int(act == "silu"),
                int(scale.dtype == torch.float32), _build.stream_of(x),
            )
            _build.check(err, "fused_group_norm")
            LAUNCHES["fused_group_norm"] += 1
    return y


def fused_layer_norm(x, scale, bias, eps=1e-5):
    """LayerNorm over the last axis of a (..., C) bf16 or fp32 tensor."""
    _check_affine("fused_layer_norm", x, scale, bias)
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    return plain_vjp(functools.partial(_layer_norm_kernel, eps=eps),
                     functools.partial(layer_norm_plain, eps=eps), x, scale, bias)


def _layer_norm_kernel(x, scale, bias, eps):
    _build.require_cuda("fused_layer_norm", x,
                             dtypes=(torch.bfloat16, torch.float32))
    c = x.shape[-1]
    if c % 2:
        raise ValueError(f"fused_layer_norm: C={c} must be even")
    x = x.contiguous()
    rows = x.numel() // c
    scale, bias = _kernel_affine(x, scale, bias)
    y = torch.empty_like(x)
    lanes = ln_plan(c, x.element_size())
    if any(t.data_ptr() % 16 for t in (x, y, scale, bias)):
        lanes = 0
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.idt_layer_norm(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
            rows, c, float(eps), int(x.dtype == torch.float32),
            int(scale.dtype == torch.float32), lanes, _build.stream_of(x),
        )
    _build.check(err, "fused_layer_norm")
    LAUNCHES["fused_layer_norm"] += 1
    return y
