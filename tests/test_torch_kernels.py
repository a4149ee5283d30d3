"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each kernel wrapper takes its plain PyTorch version, so these
tests hold the plain versions (which the kernels are compared with on the
card) against the Pallas kernels run as the JAX tests run them
(interpret=True) and against the JAX package's unfused formulas. Inputs are
float32 from a seeded numpy generator; JAX runs at
jax_default_matmul_precision="highest" (tests/conftest.py).

The kernels themselves are checked on the card in tests/test_torch_cuda.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instancediffusion_tpu.kernels import flash_attention as jfa
from instancediffusion_tpu.kernels import norms as jnorms
from instancediffusion_tpu.models import unet as junet
from instancediffusion_tpu.nn import core as jnn
from instancediffusion_tpu_torch import kernels
from instancediffusion_tpu_torch.kernels import flash_attention as fa
from instancediffusion_tpu_torch.kernels import geglu_ff as ff
from instancediffusion_tpu_torch.kernels import norms
from instancediffusion_tpu_torch.models import unet as punet
from instancediffusion_tpu_torch.nn import core as pnn

# fp32 on both sides: differences are summation order only
ATOL = RTOL = 1e-4


def _rand(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _close(port, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,c,kv_len", [
    (256, 256, 40, None),   # ds1-like head dim
    (200, 300, 40, None),   # ragged q and kv
    (256, 384, 40, 300),    # kv pre-padded past kv_len
    (128, 128, 64, None),
])
def test_flash_attention_plain_matches_pallas(n, m, c, kv_len):
    rng = np.random.default_rng(0)
    q, k, v = (_rand(rng, 2, 2, s, c) for s in (n, m, m))
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                              block_k=128, interpret=True, kv_len=kv_len)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             kv_len=kv_len)
    _close(out, ref)


@pytest.mark.parametrize("n,m,kv_len", [(256, 256, None), (256, 384, 300), (200, 300, None)])
def test_flash_attention_packed_plain_matches_pallas(n, m, kv_len):
    rng = np.random.default_rng(1)
    heads, c = 2, 80
    q, k, v = (_rand(rng, 2, s, heads * c) for s in (n, m, m))
    ref = jfa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                     block_q=128, block_k=128, interpret=True,
                                     kv_len=kv_len)
    out = fa.flash_attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), heads, kv_len=kv_len)
    _close(out, ref)


def test_flash_attention_pre_scaled_matches_pallas():
    rng = np.random.default_rng(2)
    q, k, v = (_rand(rng, 1, 2, 256, 40) for _ in range(3))
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=128,
                              block_k=128, interpret=True, pre_scaled=True)
    out = fa.flash_attention(*(torch.from_numpy(t) for t in (q, k, v)), pre_scaled=True)
    _close(out, ref)


def _labels(rng, length, pattern):
    """(bits, open) int32 (2, length): sample 0 follows `pattern`, sample 1
    is fully open (as the CFG null half is).
      random: up to 3 instance bits per position, some GROUNDING_BIT, ~5 %
              open positions
      late:   positions < 256 carry instance 0, the rest instance 1, none
              open: rows >= 256 find no kept key in their first 256 keys
              (two Pallas blocks of 128, four CUDA tiles of 64)"""
    bits = np.zeros((2, length), np.int32)
    open_ = np.zeros((2, length), np.int32)
    if pattern == "random":
        bits[0] = rng.integers(0, 8, length) | np.where(rng.uniform(size=length) < 0.1,
                                                        jfa.GROUNDING_BIT, 0)
        open_[0] = rng.uniform(size=length) < 0.05
    else:
        bits[0] = np.where(np.arange(length) < 256, 1, 2)
    open_[1] = 1
    return bits, open_


@pytest.mark.parametrize("n,m,kv_len,pattern", [
    (256, 256, None, "random"),
    (200, 300, None, "random"),   # ragged q and kv
    (256, 384, 300, "random"),    # kv pre-padded past kv_len
    (384, 400, None, "late"),     # rows whose first key blocks are fully masked
])
def test_flash_attention_labeled_plain_matches_pallas(n, m, kv_len, pattern):
    rng = np.random.default_rng(10)
    q, k, v = (_rand(rng, 2, 2, s, 40) for s in (n, m, m))
    bits, open_ = _labels(rng, m, pattern)
    ref = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              labels=(jnp.asarray(bits), jnp.asarray(open_)), block_q=128,
                              block_k=128, interpret=True, kv_len=kv_len)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             labels=(torch.from_numpy(bits), torch.from_numpy(open_)),
                             kv_len=kv_len)
    _close(out, ref)


@pytest.mark.parametrize("n,m,kv_len,pattern", [
    (256, 256, None, "random"),
    (200, 300, None, "random"),
    (256, 384, 300, "random"),
    (384, 400, None, "late"),
])
def test_flash_attention_packed_labeled_plain_matches_pallas(n, m, kv_len, pattern):
    rng = np.random.default_rng(11)
    heads, c = 2, 80
    q, k, v = (_rand(rng, 2, s, heads * c) for s in (n, m, m))
    bits, open_ = _labels(rng, m, pattern)
    ref = jfa.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads,
                                     labels=(jnp.asarray(bits), jnp.asarray(open_)),
                                     block_q=128, block_k=128, interpret=True,
                                     kv_len=kv_len)
    out = fa.flash_attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), heads,
                                    labels=(torch.from_numpy(bits), torch.from_numpy(open_)),
                                    kv_len=kv_len)
    _close(out, ref)


def test_flash_attention_labels_must_cover_the_sequence():
    q = torch.zeros(2, 2, 64, 16)
    bits = torch.zeros(2, 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_attention(q, q, q, labels=(bits.long(), bits.long()))
    with pytest.raises(ValueError, match="cover"):
        fa.flash_attention(q, q, q, labels=(bits[:, :32], bits[:, :32]))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,c,eps,act", [
    (64, 320, 1e-5, "silu"), (256, 640, 1e-6, "none"), (16, 512, 1e-6, "silu"),
])
def test_group_norm_plain_matches_pallas_and_nn(n, c, eps, act):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, n, c, scale=3.0, shift=0.5)
    sc, bi = _rand(rng, c), _rand(rng, c)
    out = norms.fused_group_norm(torch.from_numpy(x), torch.from_numpy(sc),
                                 torch.from_numpy(bi), 32, eps, act)
    pallas = jnorms.fused_group_norm(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi), 32,
                                     eps, act, True)
    _close(out, pallas)
    p = {"scale": jnp.asarray(sc), "bias": jnp.asarray(bi)}
    ref = jnn.group_norm(p, jnp.asarray(x), eps=eps, act=act)
    port = pnn.group_norm(_norm(sc, bi), torch.from_numpy(x), eps=eps, act=act)
    _close(port, ref)


@pytest.mark.parametrize("n,c,eps", [(64, 320, 1e-5), (77, 768, 1e-5), (512, 96, 1e-6)])
def test_layer_norm_plain_matches_pallas_and_nn(n, c, eps):
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, n, c, scale=2.0, shift=0.3)
    sc, bi = _rand(rng, c), _rand(rng, c)
    out = norms.fused_layer_norm(torch.from_numpy(x), torch.from_numpy(sc),
                                 torch.from_numpy(bi), eps)
    pallas = jnorms.fused_layer_norm(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi), eps,
                                     True)
    _close(out, pallas)
    ref = jnn.layer_norm({"scale": jnp.asarray(sc), "bias": jnp.asarray(bi)},
                         jnp.asarray(x), eps=eps)
    _close(pnn.layer_norm(_norm(sc, bi), torch.from_numpy(x), eps=eps), ref)


def _norm(sc, bi):
    m = pnn.Norm(sc.shape[0])
    m.weight.data.copy_(torch.from_numpy(sc))
    m.bias.data.copy_(torch.from_numpy(bi))
    return m


# ---------------------------------------------------------------------------
# GEGLU feed-forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,c", [(64, 64), (40, 128)])
def test_ff_geglu_plain_matches_erf_formula(n, c):
    """The JAX CPU path of _apply_ff_geglu is the exact-erf GEGLU (not the
    Pallas kernel's tanh approximation)."""
    rng = np.random.default_rng(5)
    inner = 4 * c
    x = _rand(rng, 2, n, c)
    w1, b1 = _rand(rng, c, 2 * inner, scale=c ** -0.5), _rand(rng, 2 * inner, scale=0.1)
    w2, b2 = _rand(rng, inner, c, scale=inner ** -0.5), _rand(rng, c, scale=0.1)
    jp = {"proj": {"w": jnp.asarray(w1), "b": jnp.asarray(b1)},
          "out": {"w": jnp.asarray(w2), "b": jnp.asarray(b2)}}
    ref = junet._apply_ff_geglu(jp, jnp.asarray(x))
    t = torch.from_numpy
    out = ff.fused_ff_geglu(t(x), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2))
    _close(out, ref)
    mod = punet.FeedForward(c)
    mod.proj.weight.data.copy_(t(w1.T.copy()))
    mod.proj.bias.data.copy_(t(b1))
    mod.out.weight.data.copy_(t(w2.T.copy()))
    mod.out.bias.data.copy_(t(b2))
    _close(punet._apply_ff_geglu(mod, t(x)), ref)
    with pnn.plain_kernels():
        _close(punet._apply_ff_geglu(mod, t(x)), ref)


def test_cpu_wrappers_take_plain_path_and_count_nothing():
    """With a CPU tensor every wrapper returns its plain version's result
    and launches nothing."""
    rng = np.random.default_rng(6)
    kernels.reset_launch_counts()
    x = torch.from_numpy(_rand(rng, 2, 64, 64)).to(torch.bfloat16)
    sc, bi = torch.ones(64), torch.zeros(64)
    assert torch.equal(norms.fused_group_norm(x, sc, bi, 32, 1e-5, "silu"),
                       norms.group_norm_plain(x, sc, bi, 32, 1e-5, "silu"))
    assert torch.equal(norms.fused_layer_norm(x, sc, bi), norms.layer_norm_plain(x, sc, bi))
    w1, w2 = torch.randn(512, 64).bfloat16(), torch.randn(64, 256).bfloat16()
    assert torch.equal(ff.fused_ff_geglu(x, w1, torch.zeros(512), w2, torch.zeros(64)),
                       ff.ff_geglu_plain(x, w1, torch.zeros(512), w2, torch.zeros(64)))
    q = x.reshape(2, 64, 4, 16).transpose(1, 2)
    fa.flash_attention(q, q, q)
    fa.flash_attention_packed(x, x, x, 4)
    labels = (torch.ones(2, 64, dtype=torch.int32), torch.zeros(2, 64, dtype=torch.int32))
    fa.flash_attention(q, q, q, labels=labels)
    fa.flash_attention_packed(x, x, x, 4, labels=labels)
    assert sum(kernels.LAUNCHES.values()) == 0


def test_wrappers_reject_mismatched_shapes():
    x = torch.zeros(1, 64, 4, 16)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(x, x[:, :, :, :8], x)
    with pytest.raises(ValueError, match="heads"):
        fa.flash_attention_packed(torch.zeros(1, 8, 30), torch.zeros(1, 8, 30),
                                  torch.zeros(1, 8, 30), 4)
    with pytest.raises(ValueError, match="fit C"):
        norms.fused_layer_norm(torch.zeros(2, 8), torch.ones(4), torch.zeros(8))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No fallback: without nvcc the first kernel build raises."""
    from instancediffusion_tpu_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


# ---------------------------------------------------------------------------
# training: trainable attention, its backward, and the norm / GEGLU VJPs
# ---------------------------------------------------------------------------
# fp32 on both sides: differences are summation order only (1e-4). The
# Pallas GEGLU kernel and its VJP use the tanh GELU, the port (like the JAX
# model's own CPU path) the exact erf one: their gradients differ by the
# approximation, up to ~2e-3 of the largest gradient entry.
GELU_TANH_REL = 5e-3


def _grad_close(port, ref, rel=ATOL):
    """max |port - ref| <= rel * max |ref| (and within atol for all-zero refs)."""
    ref = np.asarray(ref)
    err = np.abs(port.detach().numpy() - ref).max()
    assert err <= rel * max(np.abs(ref).max(), 1.0), (err, np.abs(ref).max())


def _attn_case(rng, n, m, c, pattern):
    q, k, v, w = (_rand(rng, 1, 2, s, c) for s in (n, m, m, n))
    labels = None if pattern is None else _labels(rng, m, pattern)
    if labels is not None:  # batch 1: sample 0's labels
        labels = tuple(a[:1] for a in labels)
    return q, k, v, w, labels


@pytest.mark.parametrize("n,m,c,pattern", [
    (128, 128, 40, None),
    (160, 77, 40, None),       # ragged q and kv
    (128, 160, 40, "random"),
    (384, 400, 40, "late"),    # rows whose first key blocks are fully masked
])
def test_trainable_attention_grads_match_pallas(n, m, c, pattern):
    """Loss sum(out * w) and dq/dk/dv of the port's trainable attention (the
    CPU route: autograd of sdpa_xla) against the Pallas custom VJP
    (flash_attention_trainable(_labeled), interpret mode)."""
    import jax

    rng = np.random.default_rng(20)
    q, k, v, w, labels = _attn_case(rng, n, m, c, pattern)

    def jloss(q, k, v):
        if labels is None:
            out = jfa.flash_attention_trainable(q, k, v, 64, 64, True)
        else:
            out = jfa.flash_attention_trainable_labeled(
                q, k, v, jnp.asarray(labels[0]), jnp.asarray(labels[1]), 64, 64, True)
        return jnp.sum(out * jnp.asarray(w))

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    if labels is None:
        out = fa.flash_attention_trainable(tq, tk, tv)
    else:
        out = fa.flash_attention_trainable_labeled(tq, tk, tv, *map(torch.from_numpy, labels))
    loss = (out * torch.from_numpy(w)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for t, ref in zip((tq, tk, tv), jg):
        _grad_close(t.grad, ref)


@pytest.mark.parametrize("n,m,pattern", [(128, 128, None), (160, 77, None),
                                         (384, 400, "late")])
def test_flash_bwd_plain_matches_pallas_on_its_residuals(n, m, pattern):
    """flash_attention_bwd_plain on the Pallas forward's own residuals (out
    and lse, the latter converted from base e to the port's base 2) against
    _flash_bwd; and the port's forward-with-lse against _fwd_with_stats."""
    rng = np.random.default_rng(21)
    q, k, v, g, labels = _attn_case(rng, n, m, 40, pattern)
    jlabels = None if labels is None else tuple(jnp.asarray(a) for a in labels)
    out, res = jfa._fwd_with_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jlabels,
                                   64, 64, True)
    jdq, jdk, jdv = jfa._flash_bwd(res, jnp.asarray(g), 64, 64, True)
    lse_e = np.asarray(res[4]).reshape(1, 2, -1)[:, :, :n]
    t = torch.from_numpy
    tlabels = None if labels is None else tuple(map(t, labels))
    dq, dk, dv = fa.flash_attention_bwd_plain(t(q), t(k), t(v), t(np.array(out)),
                                              t(lse_e / math.log(2.0)), t(g), tlabels)
    for port, ref in ((dq, jdq), (dk, jdk), (dv, jdv)):
        _grad_close(port, ref)
    pout, plse = fa.flash_attention_fwd_lse_plain(t(q), t(k), t(v), tlabels)
    _close(pout, out)
    _close(plse * math.log(2.0), lse_e)
    # the CPU wrappers of the kernels return the plain versions
    _close(fa.flash_attention_bwd_dq(t(q), t(k), t(v), pout, plse, t(g), tlabels), jdq)
    for port, ref in zip(fa.flash_attention_bwd_dkv(t(q), t(k), t(v), pout, plse, t(g),
                                                    tlabels), (jdk, jdv)):
        _grad_close(port, ref)


def test_flash_bwd_plain_row_without_kept_key_is_zero():
    """A labeled row that keeps no key (possible only for rows at or past
    kv_len) has lse = -inf and output 0, and gives zero, finite gradients."""
    rng = np.random.default_rng(22)
    q, k, v, g = (torch.from_numpy(_rand(rng, 1, 1, s, 8)) for s in (4, 2, 2, 4))
    bits = torch.tensor([[1, 1, 2, 4]], dtype=torch.int32)  # rows 2, 3: no kept key
    labels = (bits, torch.zeros_like(bits))
    out, lse = fa.flash_attention_fwd_lse_plain(q, k, v, labels)
    assert torch.isinf(lse[0, 0, 2:]).all() and (out[0, 0, 2:] == 0).all()
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, out, lse, g, labels)
    assert all(torch.isfinite(d).all() for d in (dq, dk, dv))
    assert (dq[0, 0, 2:] == 0).all()


def _vjp_cases():
    return [("group_norm", (64, 320), dict(num_groups=32, eps=1e-5, act="silu")),
            ("group_norm", (16, 512), dict(num_groups=32, eps=1e-6, act="none")),
            ("layer_norm", (77, 768), dict(eps=1e-5)),
            ("layer_norm", (64, 96), dict(eps=1e-6))]


@pytest.mark.parametrize("kind,shape,kw", _vjp_cases())
def test_norm_vjp_matches_pallas_custom_vjp(kind, shape, kw):
    """The port's norm gradients (the CPU wrapper's autograd, and the
    PlainVJP Function that the CUDA route wraps the kernel in, here around
    the plain version) against jax.vjp of the Pallas kernels' custom VJP."""
    import functools

    import jax

    from instancediffusion_tpu_torch.kernels._vjp import PlainVJP

    rng = np.random.default_rng(23)
    x = _rand(rng, 2, *shape, scale=2.0, shift=0.3)
    sc, bi = _rand(rng, shape[1]), _rand(rng, shape[1])
    g = _rand(rng, 2, *shape)
    if kind == "group_norm":
        jfn = lambda x, s, b: jnorms.fused_group_norm(x, s, b, kw["num_groups"], kw["eps"],
                                                      kw["act"], True)
        wrapper, plain = norms.fused_group_norm, norms.group_norm_plain
    else:
        jfn = lambda x, s, b: jnorms.fused_layer_norm(x, s, b, kw["eps"], True)
        wrapper, plain = norms.fused_layer_norm, norms.layer_norm_plain
    _, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(sc), jnp.asarray(bi))
    ref = vjp(jnp.asarray(g))
    plain_kw = functools.partial(plain, **kw)
    for route in ("wrapper", "function"):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, sc, bi)]
        y = wrapper(*ts, **kw) if route == "wrapper" else PlainVJP.apply(plain_kw, plain_kw, *ts)
        y.backward(torch.from_numpy(g))
        for t, r in zip(ts, ref):
            _grad_close(t.grad, r)


def test_ff_geglu_vjp_matches_erf_model_and_pallas_custom_vjp():
    """GEGLU gradients (CPU wrapper, and PlainVJP with the unfused
    compute-dtype formula the CUDA route recomputes) against jax.vjp of the
    JAX model's exact-erf FF (1e-4) and of the Pallas kernel's custom VJP,
    whose tanh GELU differs by the approximation (GELU_TANH_REL); fp32
    inputs here, bf16 in the next test."""
    import jax

    from instancediffusion_tpu_torch.kernels._vjp import PlainVJP

    rng = np.random.default_rng(24)
    c, inner = 64, 256
    x, g = _rand(rng, 2, 40, c), _rand(rng, 2, 40, c)
    w1, b1 = _rand(rng, c, 2 * inner, scale=c ** -0.5), _rand(rng, 2 * inner, scale=0.1)
    w2, b2 = _rand(rng, inner, c, scale=inner ** -0.5), _rand(rng, c, scale=0.1)
    jargs = [jnp.asarray(a) for a in (x, w1, b1, w2, b2)]

    def erf_ff(x, w1, b1, w2, b2):
        return junet._apply_ff_geglu({"proj": {"w": w1, "b": b1}, "out": {"w": w2, "b": b2}}, x)

    erf_ref = jax.vjp(erf_ff, *jargs)[1](jnp.asarray(g))
    tanh_ref = jax.vjp(lambda *a: jfa_ff().fused_ff_geglu(*a, True), *jargs)[1](jnp.asarray(g))
    for route in ("wrapper", "function"):
        # port weights in torch Linear layout: w1 (2*inner, C), w2 (C, inner)
        ts = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
        fn = ff.fused_ff_geglu if route == "wrapper" else (
            lambda *a: PlainVJP.apply(ff.ff_geglu_plain, ff.ff_geglu_unfused, *a))
        fn(*ts).backward(torch.from_numpy(g))
        grads = [ts[0].grad, ts[1].grad.T, ts[2].grad, ts[3].grad.T, ts[4].grad]
        for port, e_ref, t_ref in zip(grads, erf_ref, tanh_ref):
            _grad_close(port, e_ref)
            _grad_close(port, t_ref, rel=GELU_TANH_REL)


def jfa_ff():
    from instancediffusion_tpu.kernels import geglu_ff

    return geglu_ff


# bf16 on both sides: each product's result and the gated intermediate are
# rounded to bf16 (relative 2^-9 each), and the two frameworks sum in another
# order; the JAX unfused formula also uses the tanh GELU (GELU_TANH_REL)
BF16_ROUTE_REL = 2e-2


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def test_ff_geglu_bf16_vjp_matches_jax_vjp_of_unfused():
    """The K5 gradient on the card is autograd of `ff_geglu_unfused`,
    recomputed in the compute dtype with fp32 accumulation, as the JAX
    package's `jax.vjp(_ff_unfused)`: on bf16 inputs the forward and every
    gradient agree within BF16_ROUTE_REL of the largest reference value, and
    no tensor of the recompute is fp32."""
    import jax

    from instancediffusion_tpu_torch.kernels._vjp import PlainVJP

    rng = np.random.default_rng(31)
    c, inner = 64, 256
    x, g = _rand(rng, 2, 40, c), _rand(rng, 2, 40, c)
    w1, b1 = _rand(rng, c, 2 * inner, scale=c ** -0.5), _rand(rng, 2 * inner, scale=0.1)
    w2, b2 = _rand(rng, inner, c, scale=inner ** -0.5), _rand(rng, c, scale=0.1)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (x, w1, b1, w2, b2)]
    ref_out, vjp = jax.vjp(jfa_ff()._ff_unfused, *jargs)
    ref = vjp(jnp.asarray(g, jnp.bfloat16))
    ts = [_bf16(a).requires_grad_(True) for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)]
    out = PlainVJP.apply(ff.ff_geglu_unfused, ff.ff_geglu_unfused, *ts)
    assert out.dtype == torch.bfloat16
    _grad_close(out.float(), np.asarray(ref_out, np.float32), rel=BF16_ROUTE_REL)
    out.backward(_bf16(g))
    grads = [ts[0].grad, ts[1].grad.T, ts[2].grad, ts[3].grad.T, ts[4].grad]
    for port, r in zip(grads, ref):
        assert port.dtype == torch.bfloat16
        _grad_close(port.float(), np.asarray(r, np.float32), rel=BF16_ROUTE_REL)


@pytest.mark.parametrize("n,c", [(64, 64), (40, 96)])
def test_ff_geglu_unfused_matches_jax_unfused(n, c):
    """The unfused route (what `ff_fits` sends away from the kernel) against
    the JAX package's `_ff_unfused`: in fp32 within the tanh-vs-erf GELU
    difference, in bf16 within BF16_ROUTE_REL."""
    rng = np.random.default_rng(32)
    inner = 4 * c
    x = _rand(rng, 2, n, c)
    w1, b1 = _rand(rng, c, 2 * inner, scale=c ** -0.5), _rand(rng, 2 * inner, scale=0.1)
    w2, b2 = _rand(rng, inner, c, scale=inner ** -0.5), _rand(rng, c, scale=0.1)
    t = torch.from_numpy
    ref = jfa_ff()._ff_unfused(*(jnp.asarray(a) for a in (x, w1, b1, w2, b2)))
    out = ff.ff_geglu_unfused(t(x), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2))
    _grad_close(out, ref, rel=GELU_TANH_REL)
    # and exactly the plain version's formula in fp32
    _close(out, ff.ff_geglu_plain(t(x), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2)).numpy())
    ref16 = jfa_ff()._ff_unfused(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w1, b1, w2, b2)))
    out16 = ff.ff_geglu_unfused(*(_bf16(a) for a in (x, w1.T.copy(), b1, w2.T.copy(), b2)))
    assert out16.dtype == torch.bfloat16
    _grad_close(out16.float(), np.asarray(ref16, np.float32), rel=BF16_ROUTE_REL)


@pytest.mark.parametrize("masked,pre_scaled", [(False, False), (True, False), (False, True)])
def test_routed_sdpa_matches_jax_sdpa_xla_in_bf16(masked, pre_scaled):
    """`sdpa_xla`, the route of every attention call the flash kernels do not
    take, at the JAX package's precision: bf16 operands, fp32 scores and
    softmax, probabilities rounded to bf16 before P V, a bf16 result. Held
    to JAX's `sdpa_xla` on the same bf16 inputs within BF16_ROUTE_REL; in
    fp32 the routed form and the all-fp32 oracle `sdpa_fp32` coincide."""
    from instancediffusion_tpu.ops import attention as jattn
    from instancediffusion_tpu_torch.ops.attention import sdpa_fp32, sdpa_xla

    rng = np.random.default_rng(33)
    q, k, v = (_rand(rng, 2, 2, s, 40) for s in (96, 77, 77))
    mask = (rng.uniform(size=(2, 1, 96, 77)) > 0.3) if masked else None
    if masked:
        mask[..., 0] = True
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ref = jattn.sdpa_xla(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), mask=jm,
                         pre_scaled=pre_scaled)
    out = sdpa_xla(_bf16(q), _bf16(k), _bf16(v), mask=tm, pre_scaled=pre_scaled)
    assert out.dtype == torch.bfloat16
    _grad_close(out.float(), np.asarray(ref, np.float32), rel=BF16_ROUTE_REL)
    # the oracle differs from the route only by the bf16 roundings
    _grad_close(out.float(), sdpa_fp32(_bf16(q), _bf16(k), _bf16(v), mask=tm,
                                       pre_scaled=pre_scaled).float().numpy(),
                rel=BF16_ROUTE_REL)
    t = torch.from_numpy
    ref32 = jattn.sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm,
                           pre_scaled=pre_scaled)
    _close(sdpa_xla(t(q), t(k), t(v), mask=tm, pre_scaled=pre_scaled), ref32)
    _close(sdpa_fp32(t(q), t(k), t(v), mask=tm, pre_scaled=pre_scaled), ref32)


def test_kernel_train_route_and_checks():
    """impl="kernel_train" sends long calls to the trainable kernels (their
    CPU route equals plain attention) and refuses what they do not take."""
    from instancediffusion_tpu_torch.ops.attention import multi_head_attention

    rng = np.random.default_rng(25)
    # bf16: the kernels' dtype (fp32 calls stay on the plain route)
    q, k = (torch.from_numpy(_rand(rng, 1, s, 64)).bfloat16() for s in (1024, 600))
    out = multi_head_attention(q, k, k, 2, impl="kernel_train")
    # the CPU route is the all-fp32 oracle; the plain route rounds the
    # probabilities to bf16 first
    _grad_close(out.float(), multi_head_attention(q, k, k, 2, impl="plain").float().numpy(),
                rel=BF16_ROUTE_REL)
    q32 = q.float()
    assert torch.equal(multi_head_attention(q32, q32, q32, 2, impl="kernel_train"),
                       multi_head_attention(q32, q32, q32, 2, impl="plain"))
    with pytest.raises(ValueError, match="unscaled"):
        multi_head_attention(q, k, k, 2, impl="kernel_train", pre_scaled=True)
    with pytest.raises(ValueError, match="dense mask"):
        multi_head_attention(q, k, k, 2, impl="kernel_train",
                             mask=torch.ones(1, 1, 1024, 600, dtype=torch.bool))
