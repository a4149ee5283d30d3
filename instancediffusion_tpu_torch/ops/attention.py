"""Multi-head attention (counterpart of `instancediffusion_tpu/ops/attention.py`).

`sdpa_xla` is plain attention at the JAX package's precision: operands in
the compute dtype, fp32 scores and softmax, probabilities rounded to the
compute dtype before P V. It is the route of every call the flash kernels
do not take. `sdpa_fp32` is the same function with every product in fp32,
rounded once on output: the flash kernels' plain version (their oracle).
`multi_head_attention` keeps the JAX routing (`flash_route`): long bf16
sequences (`is_big`) and instance labels go to the flash kernel, packed when
the head dim is at least 64 and split-heads below; everything else
(cross-attention over 77 tokens, ds4/ds8, a dense mask, any other dtype)
stays plain, and a plain call with labels expands them with
`labels_to_dense`. `impl="kernel_train"` (JAX's "pallas_train") routes the
same long calls to the differentiable kernels, split-heads at every head
dim, with unscaled q.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from instancediffusion_tpu_torch.kernels import kernel_dtype

_NEG_INF = -1e9


def _split_heads(x, num_heads: int):
    b, n, hc = x.shape
    return x.reshape(b, n, num_heads, hc // num_heads).transpose(1, 2)


def _merge_heads(x):
    b, h, n, c = x.shape
    return x.transpose(1, 2).reshape(b, n, h * c)


def _softmax_scores(sim, mask):
    if mask is not None:
        sim = sim.masked_fill(~mask, _NEG_INF)
    return torch.softmax(sim, dim=-1)


def sdpa_fp32(q, k, v, mask=None, pre_scaled=False):
    """Attention over (B,H,N,c) tensors with every product in fp32, rounded
    once on output: the flash kernels' plain version.

    mask: optional boolean keep-mask broadcastable to (B,H,N,M); dropped
    scores are filled with -1e9 before the softmax. pre_scaled: 1/sqrt(c)
    was already folded into q."""
    scale = 1.0 if pre_scaled else q.shape[-1] ** -0.5
    sim = torch.einsum("bhnc,bhmc->bhnm", q.float(), k.float()) * scale
    attn = _softmax_scores(sim, mask)
    return torch.einsum("bhnm,bhmc->bhnc", attn, v.float()).to(q.dtype)


KEY_PAD = 8  # fp32 score rows padded to 32 bytes keep cuBLAS on the tensor cores


def padded_scores(q, k):
    """q k^T of (G,N,c) x (G,M,c) as fp32 (G,N,M), with the key axis padded
    by zero keys to a multiple of KEY_PAD and the scores sliced back. On the
    card, 16-bit operands multiply on the tensor cores into fp32 (an fp32
    result row of 77 scores, the ds1 cross-attention's, is not a 16-byte
    multiple, and cuBLAS then takes a SIMT kernel); elsewhere the operands
    are widened first. A zero key only adds a column that is cut off."""
    m = k.shape[1]
    kp = F.pad(k, (0, 0, 0, -m % KEY_PAD))
    if q.is_cuda:
        sim = torch.bmm(q, kp.transpose(1, 2), out_dtype=torch.float32)
    else:
        sim = torch.bmm(q.float(), kp.float().transpose(1, 2))
    return sim[:, :, :m]


class _ScoresFn(torch.autograd.Function):
    """q k^T of (G,N,c) x (G,M,c) 16-bit operands on the tensor cores with an
    fp32 result (`padded_scores`: `bmm(out_dtype=float32)`, which autograd
    does not differentiate itself). Backward: the fp32 score gradient rounded
    to the compute dtype, as the flash backward kernels round theirs, then
    both products in that dtype with fp32 accumulation."""

    @staticmethod
    def forward(ctx, q, k):
        ctx.save_for_backward(q, k)
        return padded_scores(q, k)

    @staticmethod
    def backward(ctx, grad):
        q, k = ctx.saved_tensors
        ds = grad.to(q.dtype)
        return torch.bmm(ds, k), torch.bmm(ds.transpose(1, 2), q)


def _scores_fp32(q, k):
    """q k^T of (B,H,N,c) x (B,H,M,c) operands as fp32 (B,H,N,M): the
    operands multiplied as they are, accumulated and returned in fp32. On
    the card a 16-bit product runs on the tensor cores with an fp32 result;
    elsewhere the operands are widened first, which gives the same numbers
    (a product of two 16-bit values is exact in fp32)."""
    if q.is_cuda and q.dtype in (torch.bfloat16, torch.float16):
        b, h, n, c = q.shape
        sim = _ScoresFn.apply(q.reshape(b * h, n, c), k.reshape(b * h, -1, c))
        return sim.reshape(b, h, n, -1)
    return torch.einsum("bhnc,bhmc->bhnm", q.float(), k.float())


def sdpa_xla(q, k, v, mask=None, pre_scaled=False):
    """Attention over (B,H,N,c) tensors at the JAX package's precision
    (`instancediffusion_tpu/ops/attention.py::sdpa_xla`): q k^T from the
    compute-dtype operands into fp32 scores, fp32 softmax, the probabilities
    rounded to the compute dtype, P V in the compute dtype with fp32
    accumulation. mask and pre_scaled as in `sdpa_fp32`."""
    scale = 1.0 if pre_scaled else q.shape[-1] ** -0.5
    attn = _softmax_scores(_scores_fp32(q, k) * scale, mask).to(q.dtype)
    return torch.einsum("bhnm,bhmc->bhnc", attn, v)


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


def flash_route(impl: str, n: int, m: int, dtype, head_c: int, labels=None, mask=None) -> str:
    """Where one attention call goes, decided before the call from its impl,
    shape and dtype: "packed" or "split" (the forward flash kernel on the
    (B,N,H*c) or the head-view layout), "train" (the differentiable
    kernels) or "plain" (`sdpa_xla`). The kernels take bf16 only; any other
    dtype stays plain, as in the JAX package."""
    if not kernel_dtype(dtype) or not is_big(n, m, labels):
        return "plain"
    if impl == "kernel" and mask is None:
        return "packed" if head_c >= 64 else "split"
    if impl == "kernel_train":
        return "train"
    return "plain"


def multi_head_attention(q, k, v, num_heads: int, mask=None, labels=None,
                         impl="plain", pre_scaled=False, kv_len=None):
    """(B,N,H*c) x (B,M,H*c) -> (B,N,H*c). impl: "kernel" routes long bf16
    sequences and labeled calls to the flash kernel; "kernel_train" routes
    them to the differentiable flash kernels (unscaled q, no dense mask, no
    kv_len); "plain" never does. mask: dense (B,1,N,M) bool keep-mask
    (always plain). labels: (bits, open) int32 (B,L) over k-sequence
    positions, L >= M; q covers the first N. kv_len: true kv length when
    k/v are padded past it."""
    n, m = q.shape[1], k.shape[1]
    route = flash_route(impl, n, m, q.dtype, q.shape[2] // num_heads, labels, mask)
    if route == "packed":
        from instancediffusion_tpu_torch.kernels.flash_attention import (
            flash_attention_packed,
        )

        return flash_attention_packed(q, k, v, num_heads, labels=labels,
                                      pre_scaled=pre_scaled, kv_len=kv_len)
    qh, kh, vh = (_split_heads(t, num_heads) for t in (q, k, v))
    if route == "split":
        from instancediffusion_tpu_torch.kernels.flash_attention import (
            flash_attention,
        )

        out = flash_attention(qh, kh, vh, labels=labels, pre_scaled=pre_scaled,
                              kv_len=kv_len)
    elif route == "train":
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
