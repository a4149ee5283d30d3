"""Forward flash attention on the (B,H,N,c) and (B,N,H*c) layouts.

CUDA source: `csrc/flash_attention.cu`, one kernel for both entry points.
It replaces `instancediffusion_tpu/kernels/flash_attention.py`:
`flash_attention` (`_flash_kernel`, and `_flash_kernel_labeled` with
`labels=`) and `flash_attention_packed` (`_flash_kernel_packed`,
`_flash_kernel_packed_labeled`), forward. The kernel takes base pointers and
(batch, head, row) element strides, so the split-heads entry point reads the
head views of the projection output in place (no head-split copy) and the
packed one slices heads in-kernel. Bound by tensor-core FLOPs; fp32 online
softmax keeps the score matrix on chip, and c=40 is zero-padded to 48 in
shared memory only.

`kv_len`: the true kv length when the caller pre-padded k/v. The kernel
masks its own ragged tail, so callers may also pass unpadded kv.

`labels=(bits, open)`: instance-masked attention. Two (B, L) int32 arrays
indexed by sequence position over the k tokens (L >= kv_len; positions past
kv_len are ignored); q covers the first N positions. Labels are per batch
row and shared by every head. The kernel keeps score (i, j) iff
open_i | open_j | (bits_i & bits_j) != 0 | i == j (`instance_labels` gives
the encoding); the plain version is `sdpa_xla` under `labels_to_dense`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from instancediffusion_tpu_torch.kernels import LAUNCHES
from instancediffusion_tpu_torch.kernels import _build
from instancediffusion_tpu_torch.ops.attention import labels_to_dense, sdpa_xla

_MAX_HEAD_DIM = 128
GROUNDING_BIT = 1 << 30


def _true_kv(m: int, kv_len: int | None) -> int:
    true_m = m if kv_len is None else int(kv_len)
    if not 1 <= true_m <= m:
        raise ValueError(f"kv_len={kv_len} outside [1, {m}]")
    return true_m


def _check_labels(name, labels, b, n, kv_len):
    """(bits, open) as two int32 (B, L) tensors with L >= max(N, kv_len)."""
    bits, open_ = labels
    for t in (bits, open_):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != b:
            raise ValueError(f"{name}: labels must be int32 (B={b}, L), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if bits.shape != open_.shape or bits.shape[1] < max(n, kv_len):
        raise ValueError(f"{name}: labels {tuple(bits.shape)} do not cover "
                         f"{max(n, kv_len)} positions")


def _plain_mask(labels, n, kv_len):
    """(B,1,N,kv_len) keep-mask of the labels, for the plain version."""
    return labels_to_dense(*labels)[:, :, :n, :kv_len]


def _launch(name, q, k, v, out, b, h, n, kv_len, c, strides, pre_scaled,
            labels=None):
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
    bits_ptr = open_ptr = label_stride = 0  # null pointers: unlabeled
    if labels is not None:
        bits, open_ = (t.contiguous() for t in labels)
        if bits.device != q.device or open_.device != q.device:
            raise ValueError(f"{name}: labels on {bits.device}, q on {q.device}")
        bits_ptr, open_ptr, label_stride = bits.data_ptr(), open_.data_ptr(), bits.shape[1]
        name += "_labeled"
    lib = _build.lib()
    with torch.cuda.device(q.device):
        err = lib.idt_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bits_ptr,
            open_ptr, label_stride, b, h, n, kv_len, c, arr, float(scale),
            _build.stream_of(q),
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
    _check_shapes("flash_attention", q, k, v, (0, 1, 3))
    b, h, n, c = q.shape
    true_m = _true_kv(k.shape[2], kv_len)
    if labels is not None:
        _check_labels("flash_attention", labels, b, n, true_m)
    if q.device.type == "cpu":
        mask = None if labels is None else _plain_mask(labels, n, true_m)
        return sdpa_xla(q, k[:, :, :true_m], v[:, :, :true_m], mask=mask,
                        pre_scaled=pre_scaled)
    out = torch.empty((b, n, h, c), dtype=q.dtype, device=q.device)
    out_v = out.permute(0, 2, 1, 3)
    strides = []
    for t in (q, k, v, out_v):
        strides += [t.stride(0), t.stride(1), t.stride(2)]
    _launch("flash_attention", q, k, v, out_v, b, h, n, true_m, c, strides,
            pre_scaled, labels)
    return out_v


def flash_attention_packed(q, k, v, num_heads=8, labels=None,
                           pre_scaled=False, kv_len=None):
    """q (B,N,H*c), k/v (B,M,H*c) -> (B,N,H*c), heads sliced in-kernel."""
    _check_shapes("flash_attention_packed", q, k, v, (0, 2))
    b, n, hc = q.shape
    if hc % num_heads:
        raise ValueError(f"flash_attention_packed: width {hc} is not "
                         f"{num_heads} heads")
    c = hc // num_heads
    true_m = _true_kv(k.shape[1], kv_len)
    if labels is not None:
        _check_labels("flash_attention_packed", labels, b, n, true_m)
    if q.device.type == "cpu":
        split = lambda t: t.reshape(b, t.shape[1], num_heads, c).transpose(1, 2)
        mask = None if labels is None else _plain_mask(labels, n, true_m)
        out = sdpa_xla(split(q), split(k[:, :true_m]), split(v[:, :true_m]),
                       mask=mask, pre_scaled=pre_scaled)
        return out.transpose(1, 2).reshape(b, n, hc)
    out = torch.empty((b, n, hc), dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, out):
        strides += [t.stride(0), c, t.stride(1)]
    _launch("flash_attention_packed", q, k, v, out, b, num_heads, n, true_m, c,
            strides, pre_scaled, labels)
    return out


def instance_labels(att_masks, n_objs: int, seg_tokens: int = 64):
    """(B, n_objs, S, S) binary box/instance rasters -> per-token (bits,
    open) int32 (B, S*S + 4*n_objs + seg_tokens) labels over [visual |
    box, point, scribble, polygon grounding | seg] tokens:
      visual token:           bits = OR of (1 << k) over instances k covering it
      box/polygon token k:    bits = GROUNDING_BIT | (1 << k), not open
      point/scribble tokens:  bits = GROUNDING_BIT, open
      seg tokens:             bits = GROUNDING_BIT, open
    A sample with no mask at all is open everywhere (unmasked)."""
    b, n, s, _ = att_masks.shape
    dev = att_masks.device
    masks = att_masks.reshape(b, n, s * s) > 0
    powers = (1 << torch.arange(n, dtype=torch.int32, device=dev))
    # OR == sum: instance bits are disjoint powers of two
    vis_bits = torch.where(masks, powers[None, :, None], 0).sum(1, dtype=torch.int32)
    vis_open = torch.zeros((b, s * s), dtype=torch.int32, device=dev)

    inst_bits = (powers | GROUNDING_BIT).expand(b, n)
    gb = torch.full((b, n), GROUNDING_BIT, dtype=torch.int32, device=dev)
    closed = torch.zeros((b, n), dtype=torch.int32, device=dev)
    opened = torch.ones((b, n), dtype=torch.int32, device=dev)
    # token order [box, point, scribble, polygon]: box and polygon
    # restricted, point and scribble open
    g_bits = torch.cat([inst_bits, gb, gb, inst_bits], dim=1)
    g_open = torch.cat([closed, opened, opened, closed], dim=1)
    seg_bits = torch.full((b, seg_tokens), GROUNDING_BIT, dtype=torch.int32, device=dev)
    seg_open = torch.ones((b, seg_tokens), dtype=torch.int32, device=dev)

    bits = torch.cat([vis_bits, g_bits, seg_bits], dim=1)
    open_ = torch.cat([vis_open, g_open, seg_open], dim=1)
    has_mask = masks.any(dim=2).any(dim=1)
    return bits, torch.where(has_mask[:, None], open_, 1)
