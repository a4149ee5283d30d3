"""Multi-head attention (counterpart of `instancediffusion_tpu/ops/attention.py`).

`sdpa_xla` is plain einsum/softmax attention with fp32 scores, the port of
the JAX package's XLA path, and also the plain version of the flash
attention kernel. `multi_head_attention` keeps the JAX routing: long
sequences (`big`) go to the flash kernel, packed when the head dim is at
least 64 and split-heads below; everything else (cross-attention over 77
tokens, ds4/ds8, masked attention) stays plain.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e9


def _split_heads(x, num_heads: int):
    b, n, hc = x.shape
    return x.reshape(b, n, num_heads, hc // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, n, c = x.shape
    return x.transpose(1, 2).reshape(b, n, h * c)


def sdpa_xla(q, k, v, mask=None, pre_scaled=False):
    """Attention over (B,H,N,c) tensors in fp32, rounded once on output.

    mask: optional boolean keep-mask broadcastable to (B,H,N,M); dropped
    scores are filled with -1e9 before the softmax. pre_scaled: 1/sqrt(c)
    was already folded into q."""
    c = q.shape[-1]
    scale = 1.0 if pre_scaled else c ** -0.5
    sim = torch.einsum("bhnc,bhmc->bhnm", q.float(), k.float()) * scale
    if mask is not None:
        sim = sim.masked_fill(~mask, _NEG_INF)
    attn = torch.softmax(sim, dim=-1)
    return torch.einsum("bhnm,bhmc->bhnc", attn, v.float()).to(q.dtype)


def multi_head_attention(q, k, v, num_heads: int, mask=None, impl="plain",
                         pre_scaled=False, kv_len=None):
    """(B,N,H*c) x (B,M,H*c) -> (B,N,H*c). impl: "kernel" routes long
    sequences to the flash kernel; "plain" never does. kv_len: true kv
    length when k/v are padded past it."""
    n, m = q.shape[1], k.shape[1]
    # the flash kernel pays off on long sequences only (JAX routing)
    big = n >= 1024 and m >= 512
    head_c = q.shape[2] // num_heads
    if impl == "kernel" and big and mask is None and head_c >= 64:
        from instancediffusion_tpu_torch.kernels.flash_attention import (
            flash_attention_packed,
        )

        return flash_attention_packed(q, k, v, num_heads, pre_scaled=pre_scaled,
                                      kv_len=kv_len)
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    if impl == "kernel" and big and mask is None:
        from instancediffusion_tpu_torch.kernels.flash_attention import (
            flash_attention,
        )

        out = flash_attention(qh, kh, vh, pre_scaled=pre_scaled, kv_len=kv_len)
    else:
        if kv_len is not None:
            kh, vh = kh[:, :, :kv_len], vh[:, :, :kv_len]
        out = sdpa_xla(qh, kh, vh, mask=mask, pre_scaled=pre_scaled)
    return _merge_heads(out)
