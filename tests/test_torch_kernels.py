"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each kernel wrapper takes its plain PyTorch version, so these
tests hold the plain versions (which the kernels are compared with on the
card) against the Pallas kernels run as the JAX tests run them
(interpret=True) and against the JAX package's unfused formulas. Inputs are
float32 from a seeded numpy generator; JAX runs at
jax_default_matmul_precision="highest" (tests/conftest.py).

The kernels themselves are checked on the card in tests/test_torch_cuda.py.
"""

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
