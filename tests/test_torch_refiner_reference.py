"""The port's SDXL refiner against the benchmark's plain float32 reference
(`port_bench/reference/`: `openclip.py`, `vae_encoder.py`,
`sdxl_refiner.py`, `ddim.py`, `refine.py`) on the CPU, at tiny widths
(`port_bench/tests/tiny_refiner.py`), on the benchmark's seeded weights
(`port_bench/harness/refiner.weights`, nothing zero) loaded into both.

Both sides compute in float32 here (the port's plain routes), so they differ
only in the order of float32 sums: each tolerance is a few float32
roundings of the compared values, far below what a wrong layer, a swapped
guidance half or a lost scale factor moves.
"""

import numpy as np
import pytest
import torch

from instancediffusion_tpu_torch.models import clip_text, sdxl_refiner, vae
from port_bench.drivers.refine import options
from port_bench.harness import refiner
from port_bench.reference import tokenizer
from port_bench.reference.openclip import apply_openclip
from port_bench.reference.sdxl_refiner import adm_vector, apply_refiner_unet
from port_bench.reference.vae_encoder import vae_encode_mode
from port_bench.tests import tiny_refiner

SEED = 2**31 + 41
# float32 on both sides: agreement to a few roundings of the largest value
REL = 1e-5


@pytest.fixture(scope="module")
def sides():
    """(port pipeline, reference, traffic) on one draw of tiny weights."""
    cfg, traffic = tiny_refiner.config(), tiny_refiner.run().traffic
    w = refiner.weights(cfg, SEED, "cpu", torch.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")
        pipe = refiner.port(cfg, w, torch.float32)
    return pipe, refiner.reference(cfg, w, "cpu"), traffic


def _close(got, want):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    scale = float(want.abs().max())
    assert scale > 0.1  # nothing compared is all but zero
    assert float((got - want).abs().max()) <= REL * scale


def test_openclip_penultimate_and_pooled(sides):
    pipe, ref, _ = sides
    ids = torch.from_numpy(np.stack([tokenizer.encode("a fox and a kite by a lake"),
                                     tokenizer.encode("")])).long()
    with torch.no_grad():
        got = clip_text.apply_clip_text(pipe.text, ids)
        want = apply_openclip(ref.text, ids)
    _close(got["penultimate_hidden_state"], want["penultimate"])
    _close(got["projected_pooled"], want["pooled"])


def test_vae_encode_mode(sides):
    pipe, ref, traffic = sides
    req = refiner.request(SEED, 0, traffic, "cpu")
    x = torch.from_numpy(req.images.astype(np.float32) / 255.0 * 2.0 - 1.0)
    with torch.no_grad():
        _close(vae.vae_encode_mode(pipe.vae, x), vae_encode_mode(ref.vae, x))


def test_one_refiner_unet_forward(sides):
    pipe, ref, _ = sides
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 4, 4, 4, generator=g)
    t = torch.tensor([301, 301, 251, 1])
    ctx = torch.randn(4, 77, pipe.cfg.context_dim, generator=g)
    pooled = torch.randn(4, pipe.text_cfg.projection_dim, generator=g)
    y = adm_vector(pooled, (32, 32), (0, 0), 6.0)
    _close(sdxl_refiner.refiner_adm_vector(pooled, (32, 32), (0, 0), 6.0), y)
    with torch.no_grad():
        _close(sdxl_refiner.apply_refiner_unet(pipe.unet, x, t, ctx, y),
               apply_refiner_unet(ref.unet, x, t, ctx, y))


def test_a_whole_refine_on_the_same_noise(sides, monkeypatch):
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")  # no BPE files here
    pipe, ref, traffic = sides
    req = refiner.request(SEED, 1, traffic, "cpu")
    images = req.images.astype(np.float32) / 255.0
    got = pipe.refine(images, req.prompt, noise=req.noise, **options(traffic))
    want = ref.refine(images, req.prompt, req.noise, list(range(len(images))),
                      **options(traffic))
    # images in [0, 1] after 7 DDIM steps at guidance 5: 1e-4 is 2.6 % of one
    # uint8 level, float32 rounding carried through the steps
    assert got.shape == want.shape == images.shape
    assert np.abs(got - want).max() <= 1e-4
    assert np.abs(got - images).mean() > 0.01  # the refine changed the images
