"""Layer primitives of the plain reference: a frozen copy of the port's
`nn/core.py` plain routes (NHWC images, (B, N, C) tokens, torch parameter
layouts), with every norm, GEGLU feed-forward and attention in its plain
float32 form and no kernel anywhere.

`precision("fp8")` is the control of the output check: inside the block
every operand of a product (linear, conv, attention scores and P V) is
rounded to float8 e4m3 with one scale per tensor before an fp32 product,
the step below the bf16 the configuration is served in. Outside it
everything is float32 (run with TF32 off: `fp32_matmuls`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_FP8_MAX = 448.0  # largest finite float8 e4m3fn value
_MODE = ["fp32"]


@contextlib.contextmanager
def precision(mode: str):
    """Round every product's operands to `mode` ("fp32" or "fp8") inside
    the block."""
    if mode not in ("fp32", "fp8"):
        raise ValueError(f"unknown precision {mode!r}")
    _MODE.append(mode)
    try:
        yield
    finally:
        _MODE.pop()


@contextlib.contextmanager
def fp32_matmuls():
    """Float32 products really in float32: TF32 off for cuBLAS and cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def operand(t: torch.Tensor) -> torch.Tensor:
    """t as float32, rounded through float8 e4m3 (per-tensor scale) under
    `precision("fp8")`."""
    t = t.float()
    if _MODE[-1] == "fp32":
        return t
    scale = t.abs().amax().clamp(min=1e-30) / _FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class Linear(torch.nn.Module):
    """weight (out, in), optional bias; built empty, filled by the loader."""

    def __init__(self, in_dim, out_dim, bias=True, zero=False, *, generator=None, device=None):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.empty((out_dim, in_dim), device=device),
                                         requires_grad=False)
        self.bias = (torch.nn.Parameter(torch.empty(out_dim, device=device), requires_grad=False)
                     if bias else None)


class Conv2d(torch.nn.Module):
    """NHWC conv; weight OIHW (I = in / groups)."""

    def __init__(self, in_ch, out_ch, kernel, bias=True, zero=False, groups=1, *,
                 generator=None, device=None):
        super().__init__()
        shape = (out_ch, in_ch // groups, kernel, kernel)
        self.weight = torch.nn.Parameter(torch.empty(shape, device=device), requires_grad=False)
        self.bias = (torch.nn.Parameter(torch.empty(out_ch, device=device), requires_grad=False)
                     if bias else None)
        self.groups = groups


class Norm(torch.nn.Module):
    """Affine parameters of a GroupNorm or LayerNorm over C channels."""

    def __init__(self, num_channels, *, device=None):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.empty(num_channels, device=device),
                                         requires_grad=False)
        self.bias = torch.nn.Parameter(torch.empty(num_channels, device=device),
                                       requires_grad=False)


def param(t: torch.Tensor) -> torch.nn.Parameter:
    return torch.nn.Parameter(torch.empty_like(t), requires_grad=False)


def linear_w(x, weight, bias=None):
    """x @ weight^T + bias with the operands at the current precision."""
    b = None if bias is None else bias.float()
    return F.linear(operand(x), operand(weight), b)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    return linear_w(x, p.weight, p.bias)


def conv2d(p: Conv2d, x: torch.Tensor, stride: int = 1, padding: int = 0):
    """(B,H,W,C) -> (B,H',W',O)."""
    b = None if p.bias is None else p.bias.float()
    y = F.conv2d(operand(x).permute(0, 3, 1, 2), operand(p.weight), b, stride=stride,
                 padding=padding, groups=p.groups)
    return y.permute(0, 2, 3, 1)


def group_norm(p: Norm, x, num_groups=32, eps=1e-5, act="none"):
    """GroupNorm over the channel (last) axis, fp32 math, optional SiLU."""
    shape = x.shape
    b, c = shape[0], shape[-1]
    xf = x.float().reshape(b, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, -1, c)
    y = y * p.weight.float() + p.bias.float()
    if act == "silu":
        y = F.silu(y)
    return y.reshape(shape)


def layer_norm(p: Norm, x, eps=1e-5):
    """LayerNorm over the channel (last) axis, fp32 math."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * p.weight.float() + p.bias.float()


def ff_geglu(x, w1, b1, w2, b2):
    """GEGLU feed-forward: (x W1 + b1) split into a, g; (a * gelu(g)) W2 + b2."""
    a, g = linear_w(x, w1, b1).chunk(2, dim=-1)
    return linear_w(a * F.gelu(g), w2, b2)


def silu(x):
    return F.silu(x)


def gelu(x):
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

