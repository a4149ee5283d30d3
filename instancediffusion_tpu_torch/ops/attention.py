"""Multi-head attention (counterpart of `instancediffusion_tpu/ops/attention.py`).

`sdpa_xla` is plain einsum/softmax attention with fp32 scores, the port of
the JAX package's XLA path, and also the plain version of the flash
attention kernel. `multi_head_attention` keeps the JAX routing: long
sequences (`big`) and instance labels go to the flash kernel, packed when
the head dim is at least 64 and split-heads below; everything else
(cross-attention over 77 tokens, ds4/ds8, a dense mask) stays plain, and a
plain call with labels expands them with `labels_to_dense`. `impl=
"kernel_train"` (JAX's "pallas_train") routes the same long calls to the
differentiable kernels, split-heads at every head dim, with unscaled q.
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


def labels_to_dense(bits, open_):
    """(B,L) instance labels -> dense (B,1,L,L) bool keep-mask, the plain
    form of the flash kernel's in-kernel predicate
    keep(i,j) = open_i | open_j | (bits_i & bits_j) != 0 | i == j."""
    i = torch.arange(bits.shape[1], device=bits.device)
    keep = ((open_[:, :, None] > 0) | (open_[:, None, :] > 0)
            | ((bits[:, :, None] & bits[:, None, :]) != 0)
            | (i[:, None] == i[None, :])[None])
    return keep[:, None]


def is_big(n: int, m: int, labels=None) -> bool:
    """The flash kernels pay off on long sequences only (JAX routing): n
    queries over m keys; labeled calls always take them."""
    return (n >= 1024 and m >= 512) or labels is not None


def multi_head_attention(q, k, v, num_heads: int, mask=None, labels=None,
                         impl="plain", pre_scaled=False, kv_len=None):
    """(B,N,H*c) x (B,M,H*c) -> (B,N,H*c). impl: "kernel" routes long
    sequences and labeled calls to the flash kernel; "kernel_train" routes
    them to the differentiable flash kernels (unscaled q, no dense mask, no
    kv_len); "plain" never does. mask: dense (B,1,N,M) bool keep-mask
    (always plain). labels: (bits, open) int32 (B,L) over k-sequence
    positions, L >= M; q covers the first N. kv_len: true kv length when
    k/v are padded past it."""
    n, m = q.shape[1], k.shape[1]
    big = is_big(n, m, labels)
    head_c = q.shape[2] // num_heads
    if impl == "kernel" and big and mask is None and head_c >= 64:
        from instancediffusion_tpu_torch.kernels.flash_attention import (
            flash_attention_packed,
        )

        return flash_attention_packed(q, k, v, num_heads, labels=labels,
                                      pre_scaled=pre_scaled, kv_len=kv_len)
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    if impl == "kernel" and big and mask is None:
        from instancediffusion_tpu_torch.kernels.flash_attention import (
            flash_attention,
        )

        out = flash_attention(qh, kh, vh, labels=labels, pre_scaled=pre_scaled,
                              kv_len=kv_len)
    elif impl == "kernel_train" and big:
        # the backward computes dq = scale * ds k from unscaled q
        if pre_scaled or mask is not None or kv_len is not None:
            raise ValueError("kernel_train takes unscaled q, no dense mask and "
                             "no kv_len padding")
        from instancediffusion_tpu_torch.kernels.flash_attention import (
            flash_attention_trainable, flash_attention_trainable_labeled,
        )

        if labels is not None:
            out = flash_attention_trainable_labeled(qh, kh, vh, *labels)
        else:
            out = flash_attention_trainable(qh, kh, vh)
    else:
        m_true = m if kv_len is None else kv_len
        kh, vh = kh[:, :, :m_true], vh[:, :, :m_true]
        if labels is not None and mask is None:
            mask = labels_to_dense(*labels)[:, :, :n, :m_true]
        out = sdpa_xla(qh, kh, vh, mask=mask, pre_scaled=pre_scaled)
    return _merge_heads(out)
