"""Multi-head attention of the plain reference (the port's `ops/attention.py`
`sdpa_fp32` and `labels_to_dense`, and `kernels/flash_attention.py`'s
`instance_labels`, frozen): fp32 scores and softmax, the operands of both
products at the precision `core.precision` sets."""

from __future__ import annotations

import torch

from port_bench.reference.core import operand

_NEG_INF = -1e9
GROUNDING_BIT = 1 << 30  # the port's flash kernels' grounding-token bit


def _split_heads(x, num_heads: int):
    b, n, hc = x.shape
    return x.reshape(b, n, num_heads, hc // num_heads).transpose(1, 2)


def sdpa(q, k, v, mask=None):
    """Attention over (B,H,N,c) tensors; mask: bool keep-mask broadcastable
    to (B,H,N,M), dropped scores filled with -1e9 before the softmax."""
    sim = torch.einsum("bhnc,bhmc->bhnm", operand(q), operand(k)) * q.shape[-1] ** -0.5
    if mask is not None:
        sim = sim.masked_fill(~mask, _NEG_INF)
    attn = torch.softmax(sim, dim=-1)
    return torch.einsum("bhnm,bhmc->bhnc", operand(attn), operand(v))


def labels_to_dense(bits, open_):
    """(B,L) instance labels -> dense (B,1,L,L) keep-mask:
    keep(i,j) = open_i | open_j | (bits_i & bits_j) != 0 | i == j."""
    i = torch.arange(bits.shape[1], device=bits.device)
    keep = ((open_[:, :, None] > 0) | (open_[:, None, :] > 0)
            | ((bits[:, :, None] & bits[:, None, :]) != 0)
            | (i[:, None] == i[None, :])[None])
    return keep[:, None]


def multi_head_attention(q, k, v, num_heads: int, mask=None, labels=None):
    """(B,N,H*c) x (B,M,H*c) -> (B,N,H*c). mask: dense (B,1,N,M) keep-mask;
    labels: (bits, open) (B,L) over the key positions, q covering the first
    N."""
    n, m = q.shape[1], k.shape[1]
    if labels is not None and mask is None:
        mask = labels_to_dense(*labels)[:, :, :n, :m]
    out = sdpa(*(_split_heads(t, num_heads) for t in (q, k, v)), mask=mask)
    b, h, _, c = out.shape
    return out.transpose(1, 2).reshape(b, n, h * c)


def instance_labels(att_masks, n_objs: int, seg_tokens: int = 64):
    """(B, n_objs, S, S) binary box/instance rasters -> per-token (bits,
    open) int32 (B, S*S + 4*n_objs + seg_tokens) labels over [visual |
    box, point, scribble, polygon grounding | seg] tokens: a visual token
    carries the bits of the instances covering it; box and polygon tokens
    their instance's bit, closed; point, scribble and seg tokens open. A
    sample with no mask at all is open everywhere."""
    b, n, s, _ = att_masks.shape
    dev = att_masks.device
    masks = att_masks.reshape(b, n, s * s) > 0
    powers = (1 << torch.arange(n, dtype=torch.int32, device=dev))
    vis_bits = torch.where(masks, powers[None, :, None], 0).sum(1, dtype=torch.int32)
    vis_open = torch.zeros((b, s * s), dtype=torch.int32, device=dev)
    inst_bits = (powers | GROUNDING_BIT).expand(b, n)
    gb = torch.full((b, n), GROUNDING_BIT, dtype=torch.int32, device=dev)
    closed = torch.zeros((b, n), dtype=torch.int32, device=dev)
    opened = torch.ones((b, n), dtype=torch.int32, device=dev)
    g_bits = torch.cat([inst_bits, gb, gb, inst_bits], dim=1)
    g_open = torch.cat([closed, opened, opened, closed], dim=1)
    seg_bits = torch.full((b, seg_tokens), GROUNDING_BIT, dtype=torch.int32, device=dev)
    seg_open = torch.ones((b, seg_tokens), dtype=torch.int32, device=dev)
    bits = torch.cat([vis_bits, g_bits, seg_bits], dim=1)
    open_ = torch.cat([vis_open, g_open, seg_open], dim=1)
    has_mask = masks.any(dim=2).any(dim=1)
    return bits, torch.where(has_mask[:, None], open_, 1)
