"""Projection GEMMs that split or merge attention heads (K8, K8').

CUDA source: `csrc/head_layout.cu`. It replaces
`instancediffusion_tpu/kernels/head_layout.py::proj_split` (`_proj_split_kernel`)
and `::merge_proj` (`_merge_proj_kernel`):

  proj_split(x, [w...]) = [split_heads(x @ w^T) for w]   -> (B, H, Mpad, c)
  merge_proj(o, w, b)   = merge_heads(o) @ w^T + b        -> (B, N, C_out)

The head relayout is an address computation inside the GEMM: column j of
the projection is head j // c, channel j % c, and with c a multiple of 8
each 16-byte vector of 8 bf16 lies in one head. `proj_split` writes the
contiguous (B, H, Mpad, c) arrays the flash kernel reads, with rows >= M
zeroed; `merge_proj` reads any (B, H, N, c) view whose channels are
contiguous (the flash kernel's output is a head view of a (B, N, H, c)
buffer) and adds the bias in fp32 before its one rounding. Both accumulate
in fp32. The TPU's relayout switches (`IDTPU_HEADS_SPLIT`,
`IDTPU_HEADS_MERGE`) chose between Mosaic shuffles of the same function
and have no counterpart here.

Weights are in torch Linear layout: (out, in). On a CPU tensor the wrappers
use the plain versions; on a CUDA tensor they launch the kernel or raise.
Inference only: the outputs carry no gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from instancediffusion_tpu_torch.kernels import LAUNCHES
from instancediffusion_tpu_torch.kernels import _build

_TILE = 64  # the kernel's row and column tile


def _seq_pad(m: int, seq_pad: int | None) -> int:
    mpad = -(-m // _TILE) * _TILE if seq_pad is None else int(seq_pad)
    if mpad < m:
        raise ValueError(f"seq_pad={seq_pad} is below the sequence length {m}")
    return mpad


def _check_split(x, weights, num_heads):
    if len(weights) not in (1, 2):
        raise ValueError(f"proj_split takes 1 or 2 weights, got {len(weights)}")
    inner, c_in = weights[0].shape
    if x.dim() != 3 or x.shape[2] != c_in or any(w.shape != (inner, c_in) for w in weights):
        raise ValueError(f"proj_split: x {tuple(x.shape)} and weights "
                         f"{[tuple(w.shape) for w in weights]} do not fit")
    if inner % num_heads:
        raise ValueError(f"proj_split: width {inner} is not {num_heads} heads")
    return inner, inner // num_heads


def proj_split_plain(x, weights, num_heads: int, seq_pad: int | None = None):
    """[split_heads(x @ w^T) for w in weights] in fp32, rounded once to x's
    dtype: (B, H, Mpad, c) contiguous, rows >= M zero."""
    _, c = _check_split(x, weights, num_heads)
    b, m, _ = x.shape
    mpad = _seq_pad(m, seq_pad)
    outs = []
    for w in weights:
        y = F.pad(F.linear(x.float(), w.float()), (0, 0, 0, mpad - m)).to(x.dtype)
        outs.append(y.reshape(b, mpad, num_heads, c).transpose(1, 2).contiguous())
    return outs


def merge_proj_plain(o, w, bias=None):
    """merge_heads(o) @ w^T + bias in fp32, rounded once to o's dtype:
    (B, N, C_out)."""
    b, h, n, c = o.shape
    y = F.linear(o.transpose(1, 2).reshape(b, n, h * c).float(), w.float(),
                 None if bias is None else bias.float())
    return y.to(o.dtype)


def proj_split(x, weights, num_heads: int, seq_pad: int | None = None):
    """x (B, M, C_in) (rows may be strided: a row slice of a longer
    sequence is read in place), weights: 1 or 2 bias-free (H*c, C_in)
    projections. Returns a list of (B, H, Mpad, c) tensors, Mpad = seq_pad
    or M rounded up to 64, rows >= M zero."""
    if x.device.type == "cpu":
        return proj_split_plain(x, weights, num_heads, seq_pad)
    inner, c = _check_split(x, weights, num_heads)
    b, m, c_in = x.shape
    mpad = _seq_pad(m, seq_pad)
    _build.require_cuda("proj_split", x, *weights)
    if c_in % _TILE or inner % _TILE or c % 8:
        raise ValueError(f"proj_split: C_in={c_in} and H*c={inner} must be multiples of "
                         f"{_TILE}, head dim {c} of 8")
    if x.stride(2) != 1 or x.stride(0) % 8 or x.stride(1) % 8 or x.data_ptr() % 16:
        raise ValueError("proj_split: x needs contiguous channels and 16-byte aligned rows")
    weights = [w.contiguous() for w in weights]
    outs = [torch.empty((b, num_heads, mpad, c), dtype=x.dtype, device=x.device)
            for _ in weights]
    w1, out1 = (weights[1].data_ptr(), outs[1].data_ptr()) if len(weights) == 2 else (0, 0)
    lib = _build.lib()
    with torch.cuda.device(x.device):
        err = lib.idt_proj_split(x.data_ptr(), x.stride(0), x.stride(1), weights[0].data_ptr(),
                                 w1, outs[0].data_ptr(), out1, b, m, mpad, c_in, num_heads, c,
                                 _build.stream_of(x))
    _build.check(err, "proj_split")
    LAUNCHES["proj_split"] += 1
    return outs


def merge_proj(o, w, bias=None):
    """o (B, H, N, c), any view with contiguous channels; w (C_out, H*c);
    bias (C_out,) or None. Returns (B, N, C_out); a caller that padded the
    sequence slices [:, :n]."""
    b, h, n, c = o.shape
    c_out = w.shape[0]
    if w.shape != (c_out, h * c) or (bias is not None and bias.shape != (c_out,)):
        raise ValueError(f"merge_proj: o {tuple(o.shape)}, w {tuple(w.shape)} do not fit")
    if o.device.type == "cpu":
        return merge_proj_plain(o, w, bias)
    _build.require_cuda("merge_proj", o, w)
    if (h * c) % _TILE or c_out % _TILE or c % 8:
        raise ValueError(f"merge_proj: H*c={h * c} and C_out={c_out} must be multiples of "
                         f"{_TILE}, head dim {c} of 8")
    if o.stride(3) != 1 or any(s % 8 for s in o.stride()[:3]) or o.data_ptr() % 16:
        raise ValueError("merge_proj: o needs contiguous channels and 16-byte aligned rows")
    w = w.contiguous()
    bias = None if bias is None else bias.to(device=o.device, dtype=torch.float32).contiguous()
    out = torch.empty((b, n, c_out), dtype=o.dtype, device=o.device)
    lib = _build.lib()
    with torch.cuda.device(o.device):
        err = lib.idt_merge_proj(o.data_ptr(), o.stride(0), o.stride(1), o.stride(2),
                                 w.data_ptr(), 0 if bias is None else bias.data_ptr(),
                                 out.data_ptr(), b, n, h, c, c_out, _build.stream_of(o))
    _build.check(err, "merge_proj")
    LAUNCHES["merge_proj"] += 1
    return out
