"""Layer primitives of the port (counterpart of `instancediffusion_tpu/nn/core.py`).

Layouts follow the JAX package at every public function: images are NHWC
and tokens (B, N, C). An NHWC tensor is the same memory as an NCHW tensor in
`channels_last` format, so `conv2d` hands cuDNN the free NCHW view and gets a
channels_last result back, and the (B, N, C) view a norm, attention or FF
kernel needs is a free reshape.

Parameters follow torch conventions: Linear weights (out, in), conv weights
OIHW, norms `weight`/`bias`. Initialisers mirror the JAX package (kaiming
uniform fan-in, uniform bias) and draw from an explicit `torch.Generator`.

Norms and the GEGLU feed-forward dispatch to the hand-written kernels
(`kernels/`) by dtype, as the JAX package does: bf16 activations go to the
kernels (LayerNorm's also takes fp32 rows), any other dtype to the plain
versions, and so does everything inside a `plain_kernels()` block. Each
kernel wrapper uses its plain PyTorch version only for CPU tensors.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from instancediffusion_tpu_torch.kernels import kernel_dtype
from instancediffusion_tpu_torch.kernels.norms import (
    fused_group_norm, fused_layer_norm, group_norm_plain, layer_norm_plain,
)


def _uniform(shape, bound, generator, device):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return t.uniform_(-bound, bound, generator=generator)


class Linear(torch.nn.Module):
    """y = x @ weight^T + bias; weight (out, in)."""

    def __init__(self, in_dim, out_dim, bias=True, zero=False, *,
                 generator=None, device=None):
        super().__init__()
        if zero:
            w = torch.zeros((out_dim, in_dim), device=device)
        else:
            w = _uniform((out_dim, in_dim), math.sqrt(3.0 / in_dim), generator,
                         device)
        self.weight = torch.nn.Parameter(w, requires_grad=False)
        if bias:
            b = (torch.zeros(out_dim, device=device) if zero else
                 _uniform((out_dim,), 1.0 / math.sqrt(in_dim), generator, device))
            self.bias = torch.nn.Parameter(b, requires_grad=False)
        else:
            self.bias = None


class Conv2d(torch.nn.Module):
    """NHWC conv; weight OIHW (I = in / groups)."""

    def __init__(self, in_ch, out_ch, kernel, bias=True, zero=False, groups=1,
                 *, generator=None, device=None):
        super().__init__()
        shape = (out_ch, in_ch // groups, kernel, kernel)
        fan_in = in_ch * kernel * kernel
        if zero:
            w = torch.zeros(shape, device=device)
        else:
            w = _uniform(shape, math.sqrt(3.0 / fan_in), generator, device)
        self.weight = torch.nn.Parameter(w, requires_grad=False)
        if bias:
            b = (torch.zeros(out_ch, device=device) if zero else
                 _uniform((out_ch,), 1.0 / math.sqrt(fan_in), generator, device))
            self.bias = torch.nn.Parameter(b, requires_grad=False)
        else:
            self.bias = None
        self.groups = groups


class Norm(torch.nn.Module):
    """Affine parameters of a GroupNorm or LayerNorm over C channels."""

    def __init__(self, num_channels, *, device=None):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(num_channels, device=device),
                                         requires_grad=False)
        self.bias = torch.nn.Parameter(torch.zeros(num_channels, device=device),
                                       requires_grad=False)


def param(t: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(t, requires_grad=False)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    b = None if p.bias is None else p.bias.to(x.dtype)
    return F.linear(x, p.weight.to(x.dtype), b)


def conv2d(p: Conv2d, x: torch.Tensor, stride: int = 1, padding: int = 0):
    """(B,H,W,C) -> (B,H',W',O). The permutes are views of channels_last
    memory, not copies."""
    b = None if p.bias is None else p.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), p.weight.to(x.dtype), b, stride=stride,
                 padding=padding, groups=p.groups)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Kernel dispatch switch (mirrors no_fused_kernels() of the JAX package)
# ---------------------------------------------------------------------------

_kernels_enabled = [True]


@contextlib.contextmanager
def kernels_set(enabled: bool):
    """Within the block, the kernels are on (True) or off (False)."""
    _kernels_enabled.append(enabled)
    try:
        yield
    finally:
        _kernels_enabled.pop()


def plain_kernels():
    """Route norms, the GEGLU FF and flash attention through their plain
    PyTorch versions, on any device. For tests and the on-card reference
    pass; the main path never enters it."""
    return kernels_set(False)


def kernels_enabled() -> bool:
    return _kernels_enabled[-1]


def takes_kernel(x: torch.Tensor, fp32_too: bool = False) -> bool:
    """Whether a call on x goes to its kernel: the kernels are on and x has
    a dtype the kernel takes (`kernel_dtype`)."""
    return kernels_enabled() and kernel_dtype(x.dtype, fp32_too)


# ---------------------------------------------------------------------------
# Norms: fp32 math, cast back to the input dtype
# ---------------------------------------------------------------------------


def group_norm(p: Norm, x, num_groups=32, eps=1e-5, act="none"):
    """GroupNorm over the channel (last) axis of an NHWC / (B,N,C) tensor,
    with an optionally fused trailing SiLU (`act="silu"`)."""
    shape = x.shape
    x3 = x.reshape(shape[0], -1, shape[-1])
    fn = fused_group_norm if takes_kernel(x) else group_norm_plain
    return fn(x3, p.weight, p.bias, num_groups, eps, act).reshape(shape)


def layer_norm(p: Norm, x, eps=1e-5):
    """LayerNorm over the channel (last) axis."""
    fn = fused_layer_norm if takes_kernel(x, fp32_too=True) else layer_norm_plain
    return fn(x, p.weight, p.bias, eps)


# ---------------------------------------------------------------------------
# Activations / resampling
# ---------------------------------------------------------------------------


def silu(x):
    return F.silu(x)


def gelu(x):
    # torch nn.GELU default: exact erf formulation
    return F.gelu(x)


def upsample_nearest_2x(x):
    """Nearest-neighbour 2x upsample, NHWC."""
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)


def resize_nearest(x, size: int):
    """Nearest resize of NHWC (F.interpolate mode='nearest' indices)."""
    _, h, w, _ = x.shape
    ar = torch.arange(size, dtype=torch.float32, device=x.device)
    rows = (ar * (h / size)).long()
    cols = (ar * (w / size)).long()
    return x[:, rows][:, :, cols]
