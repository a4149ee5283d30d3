"""The port's fused projection + head split / merge (K8 `proj_split`, K8'
`merge_proj`, `kernels/head_layout.py`) against the JAX package's Pallas
kernels in interpret mode, on the same numpy inputs in float32 on the CPU,
where the wrappers take their plain versions; and the `FUSED_PROJ` route of
the port's `_apply_mha` and fuser against JAX's route.

Tolerances: K8/K8' rtol = atol = 1e-4 (fp32 summation order over <= 96
channels); the attention routes 2e-3 (as tests/test_head_layout.py holds
JAX's route to its XLA path: softmax over 1024+ keys and two projections
in fp32)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import instancediffusion_tpu.kernels.flash_attention as jfa
import instancediffusion_tpu.kernels.head_layout as jhl
import instancediffusion_tpu.models.unet as junet
from instancediffusion_tpu_torch.io.jax_params import load_jax_params
from instancediffusion_tpu_torch.kernels import head_layout as hl
from instancediffusion_tpu_torch.models import unet as punet

from tests.test_torch_bridge import densify_tree


@pytest.mark.parametrize("n_weights", [1, 2])
@pytest.mark.parametrize("b,m,c_in,heads,head_c,block_n", [
    (2, 128, 96, 4, 24, 64),    # head_c not a lane multiple, aligned sequence
    (1, 100, 64, 2, 32, 64),    # ragged sequence: zeroed tail
    (2, 84, 80, 2, 40, 128),    # ds1's head dim, one padded block
])
def test_proj_split_plain_matches_pallas(n_weights, b, m, c_in, heads, head_c, block_n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, m, c_in), dtype=np.float32)
    ws = [rng.standard_normal((c_in, heads * head_c), dtype=np.float32)
          for _ in range(n_weights)]
    refs = jhl.proj_split(jnp.asarray(x), tuple(jnp.asarray(w) for w in ws), heads,
                          block_n=block_n, interpret=True)
    mpad = -(-m // block_n) * block_n
    outs = hl.proj_split(torch.from_numpy(x), [torch.from_numpy(w.T.copy()) for w in ws],
                         heads, seq_pad=mpad)
    assert len(outs) == n_weights
    for out, ref in zip(outs, refs):
        assert tuple(out.shape) == ref.shape == (b, heads, mpad, head_c)
        assert out.is_contiguous()
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
        assert not out[:, :, m:].any()  # real zeros past M


def test_proj_split_pads_to_its_row_tile_and_reads_row_slices():
    """Without seq_pad the rows pad to 64; a row slice of a longer sequence
    (the fuser's visual query rows) is read in place."""
    rng = np.random.default_rng(1)
    cat = torch.from_numpy(rng.standard_normal((2, 150, 32), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 32), dtype=np.float32))
    (q,) = hl.proj_split(cat[:, :100], [w], 4)
    assert q.shape == (2, 4, 128, 8)
    ref = (cat[:, :100] @ w.T).reshape(2, 100, 4, 8).transpose(1, 2)
    torch.testing.assert_close(q[:, :, :100], ref, rtol=1e-5, atol=1e-5)
    assert not q[:, :, 100:].any()
    with pytest.raises(ValueError, match="seq_pad"):
        hl.proj_split(cat, [w], 4, seq_pad=100)
    with pytest.raises(ValueError, match="1 or 2 weights"):
        hl.proj_split(cat, [w, w, w], 4)


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("layout", ["bhnc", "bnhc"])
def test_merge_proj_plain_matches_pallas(with_bias, layout):
    """(B,H,N,c) contiguous, or the head view of a (B,N,H,c) buffer the flash
    kernel returns."""
    rng = np.random.default_rng(2)
    b, h, n, c, c_out = 2, 4, 128, 24, 96
    o = rng.standard_normal((b, h, n, c), dtype=np.float32)
    w = rng.standard_normal((h * c, c_out), dtype=np.float32)
    bias = rng.standard_normal((c_out,), dtype=np.float32) if with_bias else None
    ref = jhl.merge_proj(jnp.asarray(o), jnp.asarray(w),
                         None if bias is None else jnp.asarray(bias), block_n=64, interpret=True)
    ot = torch.from_numpy(o)
    if layout == "bnhc":
        ot = ot.transpose(1, 2).contiguous().transpose(1, 2)
    out = hl.merge_proj(ot, torch.from_numpy(w.T.copy()),
                        None if bias is None else torch.from_numpy(bias))
    assert tuple(out.shape) == ref.shape == (b, n, c_out)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.fixture()
def fused_jax(monkeypatch):
    """JAX's FUSED_PROJ route with its Pallas kernels in interpret mode."""
    monkeypatch.setattr(junet, "FUSED_PROJ", True)
    monkeypatch.setattr(jfa, "flash_attention", functools.partial(
        jfa.flash_attention, block_q=256, block_k=256, interpret=True))
    monkeypatch.setattr(jhl, "proj_split", functools.partial(
        jhl.proj_split, block_n=256, interpret=True))
    monkeypatch.setattr(jhl, "merge_proj", functools.partial(
        jhl.merge_proj, block_n=256, interpret=True))


@pytest.fixture()
def fused_port(monkeypatch):
    """The port's FUSED_PROJ route; records each proj_split / merge_proj
    call, so a test can tell that the route ran."""
    calls = []
    monkeypatch.setattr(punet, "FUSED_PROJ", True)
    for name in ("proj_split", "merge_proj"):
        fn = getattr(punet, name)
        monkeypatch.setattr(punet, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    return calls


def _mha_pair(seed, dim, heads):
    """A densified JAX MHA tree and the port MHA holding it."""
    tree = densify_tree(junet._init_mha(jax.random.PRNGKey(seed), dim, dim, dim), seed)
    mod = punet.MHA(dim, dim, dim)
    load_jax_params(mod, unet=tree)
    return {k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in tree.items()}, mod


def test_apply_mha_fused_route_matches_jax(fused_jax, fused_port):
    """Self-attention at n = 1024 (4 heads of 40): the port's route
    (proj_split, flash attention, merge_proj) against JAX's. The switch
    gives the route bf16 calls only; it is held to JAX in fp32 here, where
    every wrapper runs its plain version, so the route's function is called
    itself."""
    b, n, h, c = 1, 1024, 4, 40
    jp, mod = _mha_pair(0, h * c, h)
    x = np.random.default_rng(3).standard_normal((b, n, h * c)).astype(np.float32)
    ref = junet._apply_mha(jp, jnp.asarray(x), jnp.asarray(x), h, impl="pallas")
    out = punet._apply_mha_fused(mod, torch.from_numpy(x), torch.from_numpy(x), h)
    assert fused_port == ["proj_split", "proj_split", "merge_proj"]
    assert tuple(out.shape) == ref.shape == (b, n, h * c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-3, atol=2e-3)
    # and the route computes what the unfused one does
    with torch.no_grad():
        unfused = punet._apply_mha(mod, torch.from_numpy(x), torch.from_numpy(x), h, "plain")
    torch.testing.assert_close(out, unfused, rtol=2e-3, atol=2e-3)


def test_fused_route_not_taken_for_training_or_wide_heads(fused_port):
    """kernel_train (unscaled q), head dims >= 64 and any dtype but bf16 keep
    the unfused route; a bf16 inference call at head dim 32 takes the fused
    one."""
    _, mod = _mha_pair(1, 128, 2)  # head dim 64
    x = torch.randn(1, 1024, 128, generator=torch.Generator().manual_seed(0))
    xb = x.bfloat16()
    punet._apply_mha(mod, xb, xb, 2, "kernel")
    _, mod = _mha_pair(1, 128, 4)  # head dim 32
    punet._apply_mha(mod, xb, xb, 4, "kernel_train")
    punet._apply_mha(mod, x, x, 4, "kernel")  # fp32
    assert fused_port == []
    fused = punet._apply_mha(mod, xb, xb, 4, "kernel")
    assert fused_port == ["proj_split", "proj_split", "merge_proj"]
    with torch.no_grad():
        unfused = punet._apply_mha(mod, xb, xb, 4, "plain")
    torch.testing.assert_close(fused.float(), unfused.float(), rtol=4e-2, atol=4e-2)


def test_fuser_fused_route_with_labels_matches_jax(fused_jax, fused_port, monkeypatch):
    """The gated fuser with instance labels: JAX pads the grounding block to
    the flash kernel's block and masks it with kv_len; the port passes
    [x | objs] unpadded (proj_split pads and zeroes, kv_len masks)."""
    b, side, g, h, c, ctx = 2, 16, 20, 2, 40, 48
    n, dim = side * side, h * c
    tree = densify_tree(junet._init_fuser(jax.random.PRNGKey(4), dim, ctx), 4)
    mod = punet.Fuser(dim, ctx)
    load_jax_params(mod, unet=tree)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((b, n, dim)).astype(np.float32)
    objs = rng.standard_normal((b, g, ctx)).astype(np.float32)
    # sample 0: instance 0 on the first 40 visual rows, grounding tokens
    # 0-9 restricted to it and 10-19 open; sample 1 all open
    bits = np.zeros((b, n + g), np.int32)
    open_ = np.zeros((b, n + g), np.int32)
    bits[0, :40] = 1
    bits[0, n:n + 10] = 1 | (1 << 30)
    bits[0, n + 10:] = 1 << 30
    open_[0, n + 10:] = 1
    open_[1] = 1
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = junet._apply_fuser(jtree, jnp.asarray(x), jnp.asarray(objs), h, 1.0,
                             (jnp.asarray(bits), jnp.asarray(open_)), "pallas")
    labels = (torch.from_numpy(bits), torch.from_numpy(open_))
    # fp32 on the CPU: the fuser's attention calls the route's function itself
    monkeypatch.setattr(punet, "_apply_mha", lambda p, x, kv, heads, impl, kv_len=None,
                        mask=None, labels=None: punet._apply_mha_fused(p, x, kv, heads, kv_len,
                                                                       labels))
    out = punet._apply_fuser(mod, torch.from_numpy(x), torch.from_numpy(objs), h, 1.0,
                             "kernel", labels)
    assert fused_port == ["proj_split", "proj_split", "merge_proj"]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-3, atol=2e-3)
