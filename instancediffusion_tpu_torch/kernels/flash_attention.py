"""Forward flash attention on the (B,H,N,c) and (B,N,H*c) layouts.

CUDA source: `csrc/flash_attention.cu`, one kernel for both entry points.
It replaces `instancediffusion_tpu/kernels/flash_attention.py`:
`flash_attention` (`_flash_kernel`) and `flash_attention_packed`
(`_flash_kernel_packed`), forward and unlabeled. The kernel takes base
pointers and (batch, head, row) element strides, so the split-heads entry
point reads the head views of the projection output in place (no head-split
copy) and the packed one slices heads in-kernel. Bound by tensor-core FLOPs;
fp32 online softmax keeps the score matrix on chip, and c=40 is zero-padded
to 48 in shared memory only.

`kv_len`: the true kv length when the caller pre-padded k/v. The kernel
masks its own ragged tail, so callers may also pass unpadded kv.
`labels=` (instance-masked attention) is still to be ported.
"""

from __future__ import annotations

import ctypes
import math

import torch

from instancediffusion_tpu_torch.kernels import LAUNCHES
from instancediffusion_tpu_torch.kernels import _build
from instancediffusion_tpu_torch.ops.attention import sdpa_xla

_MAX_HEAD_DIM = 128


def _no_labels(labels) -> None:
    if labels is not None:
        raise NotImplementedError(
            "instance-masked flash attention (labels=) is not ported yet "
            "(ROADMAP Queue 1 item 11)"
        )


def _true_kv(m: int, kv_len: int | None) -> int:
    true_m = m if kv_len is None else int(kv_len)
    if not 1 <= true_m <= m:
        raise ValueError(f"kv_len={kv_len} outside [1, {m}]")
    return true_m


def _launch(name, q, k, v, out, b, h, n, kv_len, c, strides, pre_scaled):
    """strides: (batch, head, row) element strides of q, k, v, out."""
    _build.require_cuda(name, q, k, v)
    if c % 8 or c > _MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {c} must be a multiple of 8 <= "
                         f"{_MAX_HEAD_DIM}")
    for t in (q, k, v, out):
        if t.stride(-1) != 1 or t.data_ptr() % 16:
            raise ValueError(f"{name}: head dim must be contiguous and 16-byte "
                             "aligned")
    if any(s % 8 for s in strides):
        raise ValueError(f"{name}: strides {strides} are not 16-byte multiples")
    if b * h > 65535:
        raise ValueError(f"{name}: B*H={b * h} exceeds the grid limit")
    scale = 1.0 if pre_scaled else 1.0 / math.sqrt(c)
    arr = (ctypes.c_longlong * len(strides))(*strides)
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.idt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, n,
            kv_len, c, arr, float(scale), _build.stream_of(q),
        )
    _build.check(err, name)
    LAUNCHES[name] += 1


def _check_shapes(name, q, k, v, same):
    """k and v alike; q agrees with them on the axes in `same`."""
    if k.shape != v.shape or any(q.shape[i] != k.shape[i] for i in same):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")


def flash_attention(q, k, v, labels=None, pre_scaled=False, kv_len=None):
    """q (B,H,N,c), k/v (B,H,M,c) -> (B,H,N,c). The inputs may be strided
    head views of (B,N,H*c) projections; the output is a (B,H,N,c) view of
    a (B,N,H,c) buffer, so merging heads afterwards is free."""
    _no_labels(labels)
    _check_shapes("flash_attention", q, k, v, (0, 1, 3))
    b, h, n, c = q.shape
    true_m = _true_kv(k.shape[2], kv_len)
    if q.device.type == "cpu":
        return sdpa_xla(q, k[:, :, :true_m], v[:, :, :true_m],
                        pre_scaled=pre_scaled)
    out = torch.empty((b, n, h, c), dtype=q.dtype, device=q.device)
    out_v = out.permute(0, 2, 1, 3)
    strides = []
    for t in (q, k, v, out_v):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    _launch("flash_attention", q, k, v, out_v, b, h, n, true_m, c, strides,
            pre_scaled)
    return out_v


def flash_attention_packed(q, k, v, num_heads=8, labels=None,
                           pre_scaled=False, kv_len=None):
    """q (B,N,H*c), k/v (B,M,H*c) -> (B,N,H*c), heads sliced in-kernel."""
    _no_labels(labels)
    _check_shapes("flash_attention_packed", q, k, v, (0, 2))
    b, n, hc = q.shape
    if hc % num_heads:
        raise ValueError(f"flash_attention_packed: width {hc} is not "
                         f"{num_heads} heads")
    c = hc // num_heads
    true_m = _true_kv(k.shape[1], kv_len)
    if q.device.type == "cpu":
        split = lambda t: t.reshape(b, t.shape[1], num_heads, c).transpose(1, 2)
        out = sdpa_xla(split(q), split(k[:, :true_m]), split(v[:, :true_m]),
                       pre_scaled=pre_scaled)
        return out.transpose(1, 2).reshape(b, n, hc)
    out = torch.empty((b, n, hc), dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), c, t.stride(1)]
    _launch("flash_attention_packed", q, k, v, out, b, num_heads, n, true_m, c,
            strides, pre_scaled)
    return out
