"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked `cuda` and skips without a CUDA device. The file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerance: bf16 inputs on both sides; the plain versions compute in fp32
and round once, so max |kernel - plain| <= 1e-2 * max |plain| (the same
bound `chip_smoke.py` holds them to at every main-path shape). LayerNorm on
fp32 rows (ConvNeXt in the grounding tokenizer) differs from its plain
version only in fp32 summation order: 1e-5.
"""

import pytest
import torch

from instancediffusion_tpu_torch import kernels
from instancediffusion_tpu_torch.kernels import flash_attention as fa
from instancediffusion_tpu_torch.kernels import geglu_ff as ff
from instancediffusion_tpu_torch.kernels import norms
from instancediffusion_tpu_torch.nn import core as pnn
from instancediffusion_tpu_torch.ops.attention import sdpa_xla

REL_TOL = 1e-2
FP32_REL_TOL = 1e-5


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _rnd(g, dev, *shape, std=1.0):
    return (torch.randn(shape, generator=g, device=dev) * std).bfloat16()


def _heads(t, h):
    return t.reshape(t.shape[0], t.shape[1], h, -1).transpose(1, 2)


def _case(name, dev):
    """(kernel fn, plain fn, tolerance) at a main-path shape, batch 2."""
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s, std=1.0: _rnd(g, dev, *s, std=std)
    if name == "flash_attention":  # ds1 fuser: unpadded ragged kv
        q, k, v = rnd(2, 4096, 320), rnd(2, 4280, 320), rnd(2, 4280, 320)
        return (lambda: fa.flash_attention(_heads(q, 8), _heads(k, 8), _heads(v, 8)),
                lambda: sdpa_xla(_heads(q, 8), _heads(k, 8), _heads(v, 8)), REL_TOL)
    if name == "flash_attention_kv_len":  # ds1 fuser, kv pre-padded past kv_len
        q, k, v = rnd(2, 4096, 320), rnd(2, 4608, 320), rnd(2, 4608, 320)
        return (lambda: fa.flash_attention(_heads(q, 8), _heads(k, 8), _heads(v, 8),
                                           kv_len=4280),
                lambda: sdpa_xla(_heads(q, 8), _heads(k[:, :4280], 8),
                                 _heads(v[:, :4280], 8)), REL_TOL)
    if name == "flash_attention_packed":  # ds2 fuser, kv pre-padded past kv_len
        q, k, v = rnd(2, 1024, 640), rnd(2, 1536, 640), rnd(2, 1536, 640)

        def plain():
            out = sdpa_xla(_heads(q, 8), _heads(k[:, :1208], 8), _heads(v[:, :1208], 8))
            return out.transpose(1, 2).reshape(2, 1024, 640)

        return lambda: fa.flash_attention_packed(q, k, v, 8, kv_len=1208), plain, REL_TOL
    if name == "fused_group_norm":  # VAE decoder row
        x, sc, bi = rnd(2, 65536, 256, std=3.0), rnd(256), rnd(256)
        return (lambda: norms.fused_group_norm(x, sc, bi, 32, 1e-6, "silu"),
                lambda: norms.group_norm_plain(x, sc, bi, 32, 1e-6, "silu"), REL_TOL)
    if name == "fused_layer_norm":  # ds1 fuser concat rows
        x, sc, bi = rnd(2, 4280, 320, std=2.0), rnd(320), rnd(320)
        return (lambda: norms.fused_layer_norm(x, sc, bi),
                lambda: norms.layer_norm_plain(x, sc, bi), REL_TOL)
    if name == "fused_layer_norm_fp32":  # ConvNeXt stem rows, fp32
        x = torch.randn((1, 16384, 96), generator=g, device=dev) * 2.0 + 0.3
        sc, bi = torch.randn(96, generator=g, device=dev), torch.randn(96, generator=g, device=dev)
        return (lambda: norms.fused_layer_norm(x, sc, bi, 1e-6),
                lambda: norms.layer_norm_plain(x, sc, bi, 1e-6), FP32_REL_TOL)
    assert name == "fused_ff_geglu"  # ds2 transformer FF
    x = rnd(2, 1024, 640)
    w1, b1 = rnd(5120, 640, std=640 ** -0.5), rnd(5120, std=0.1)
    w2, b2 = rnd(640, 2560, std=2560 ** -0.5), rnd(640, std=0.1)
    return (lambda: ff.fused_ff_geglu(x, w1, b1, w2, b2),
            lambda: ff.ff_geglu_plain(x, w1, b1, w2, b2), REL_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_kv_len",
                                  "flash_attention_packed", "fused_group_norm",
                                  "fused_layer_norm", "fused_layer_norm_fp32",
                                  "fused_ff_geglu"])
def test_kernel_matches_plain_on_card(dev, name):
    kernels.reset_launch_counts()
    kern, plain, tol = _case(name, dev)
    out, ref = kern().float(), plain().float()
    torch.cuda.synchronize()
    assert sum(kernels.LAUNCHES.values()) == 1
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert (out - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.cuda
def test_nn_dispatch_launches_kernels_outside_plain_kernels(dev):
    """On a bf16 CUDA tensor the layer functions go through the kernels,
    and only plain_kernels() keeps them off."""
    x = torch.randn(2, 64, 320, device=dev).bfloat16()
    gn, ln = pnn.Norm(320, device=dev), pnn.Norm(320, device=dev)
    kernels.reset_launch_counts()
    pnn.group_norm(gn, x, act="silu")
    pnn.layer_norm(ln, x)
    assert kernels.LAUNCHES == {"fused_group_norm": 1, "fused_layer_norm": 1}
    with pnn.plain_kernels():
        pnn.group_norm(gn, x, act="silu")
        pnn.layer_norm(ln, x)
    assert sum(kernels.LAUNCHES.values()) == 2


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take(dev):
    kernels.reset_launch_counts()
    x16 = torch.zeros(1, 64, 64, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="got torch.float16"):
        norms.fused_layer_norm(x16, torch.ones(64), torch.zeros(64))
    with pytest.raises(ValueError, match="got torch.float32"):
        norms.fused_group_norm(x16.float(), torch.ones(64), torch.zeros(64))
    q = torch.zeros(1, 2, 64, 36, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(q, q, q)
    x = torch.zeros(2, 8, 96, device=dev, dtype=torch.bfloat16)
    w1 = torch.zeros(768, 96, device=dev, dtype=torch.bfloat16)
    w2 = torch.zeros(96, 384, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 64"):
        ff.fused_ff_geglu(x, w1, torch.zeros(768), w2, torch.zeros(96))
    assert sum(kernels.LAUNCHES.values()) == 0
