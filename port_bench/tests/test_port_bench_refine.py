"""The refine cell (`sdxl_refiner_512x8`) on the CPU at tiny widths
(`tiny_refiner.py`; the port's float32 plain routes against the
reference): a sound run is correct, and a run whose timed path is broken
underneath is not (a DDIM step that returns its state unchanged, half of
the batch the mean of the rest, images moved one pixel where they are
made); the same seed repeats the inputs; the refiner's FLOP count against a
hand walk of a one-level UNet; the new reference files load nothing of the
port."""

import numpy as np
import pytest
import torch

from port_bench.drivers import refine
from port_bench.harness import flops, refiner, refiner_flops
from port_bench.tests import tiny_refiner
from port_bench.tests.test_port_bench_imports import _run


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unchanged_step(monkeypatch):
    """The first DDIM step (t=301, the largest move) returns its state."""
    from instancediffusion_tpu_torch import pipeline_refiner as pr

    orig = pr.ddim_sample

    def first_step_unchanged(model_fn, sched, x, *a, **kw):
        return orig(model_fn, pr._slice_schedule(sched, sched.num_steps - 1), x, *a, **kw)

    monkeypatch.setattr(pr, "ddim_sample", first_step_unchanged)


def _half_batch(monkeypatch):
    """The second half of every batch's images is the mean of the first."""
    from instancediffusion_tpu_torch.models import vae

    orig = vae.vae_decode

    def halve(p, z):
        img = orig(p, z).clone()
        h = img.shape[0] // 2
        img[h:] = img[:h].float().mean(0, keepdim=True).to(img.dtype)
        return img

    monkeypatch.setattr(vae, "vae_decode", halve)


def _altered_answer(monkeypatch):
    """Every image moved one pixel where it is made."""
    from instancediffusion_tpu_torch.models import vae

    orig = vae.vae_decode
    monkeypatch.setattr(vae, "vae_decode", lambda p, z: torch.roll(orig(p, z), 1, dims=2))


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


def test_a_sound_run_is_correct():
    out = refine.run(tiny_refiner.run())
    assert out.correct, out.checks
    assert out.checks[0].value < 0.05  # the plain routes agree with the reference
    assert out.attempted == 1 and out.end_to_end["img_s"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = refine.run(tiny_refiner.run())
    assert not out.correct, out.checks


def test_the_same_seed_repeats_the_inputs():
    t = tiny_refiner.run().traffic
    seed = 2**31 + 5
    for i in range(3):
        a, b = refiner.request(seed, i, t, "cpu"), refiner.request(seed, i, t, "cpu")
        c = refiner.request(seed + 1, i, t, "cpu")
        assert a.prompt == b.prompt
        assert np.array_equal(a.images, b.images) and np.array_equal(a.noise, b.noise)
        assert not np.array_equal(a.images, c.images)
        assert a.images.shape == c.images.shape == (t["num_images"], t["image_size"],
                                                    t["image_size"], 3)
        assert a.images.dtype == np.uint8 and 0 < a.images.std()
        assert a.noise.shape == (t["num_images"], t["image_size"] // 8, t["image_size"] // 8, 4)
    assert refiner.request(seed, 0, t, "cpu").prompt != refiner.request(seed, 1, t, "cpu").prompt


def test_refiner_flops_match_a_hand_walk_of_a_one_level_unet():
    c, depth, k, adm, s = 64, 2, 48, 96, 8
    cfg = {"image_size": 999, "in_channels": 4, "out_channels": 4, "model_channels": c,
           "attention_resolutions": [1], "num_res_blocks": 1, "channel_mult": [1],
           "num_head_channels": 32, "transformer_depth": depth, "context_dim": k,
           "adm_in_channels": adm}
    hw, e = s * s, 4 * c
    lin = lambda n, a, b: 2 * n * a * b
    conv3 = lambda cin, cout: 2 * hw * cin * cout * 9
    res = lambda cin: conv3(cin, c) + conv3(c, c) + lin(1, e, c) + (
        2 * hw * cin * c if cin != c else 0)
    block = (4 * hw * hw * c + 4 * hw * 77 * c            # self and cross attention
             + 6 * lin(hw, c, c) + 2 * lin(77, k, c)       # q k v out, cross q out, cross k v
             + lin(hw, c, 8 * c) + lin(hw, 4 * c, c))      # GEGLU feed-forward
    attn = depth * block + 2 * lin(hw, c, c)               # proj_in, proj_out
    want = (lin(1, c, e) + lin(1, e, e) + lin(1, adm, e) + lin(1, e, e)   # time, label_emb
            + conv3(4, c)                                                # conv_in
            + res(c) + attn                                              # input block
            + res(c) + attn + res(c)                                     # middle
            + 2 * (res(2 * c) + attn)                                    # two output blocks
            + conv3(c, 4))                                               # out
    assert refiner_flops.unet_forward(cfg, 3, s) == pytest.approx(3 * want, rel=1e-12)
    # a refine counts kept_steps forwards over 2B rows
    t = {"steps": 20, "strength": 0.35, "num_images": 8, "image_size": 512}
    assert refiner_flops.kept_steps(t) == 7
    assert refiner_flops.ff_bytes(10, 4, 16) == 2 * (2 * 10 * 4 + 3 * 16 * 4 + 2 * 16 + 4)
    assert flops.linear(10, 4, 32) + flops.linear(10, 16, 4) == 6 * 10 * 4 * 16


REFERENCE_ONLY = """
import json, sys, torch
torch.set_num_threads(2)
from port_bench.harness import refiner
from port_bench.tests import tiny_refiner
ctx = tiny_refiner.run()
cfg, t = ctx.config, ctx.traffic
ref = refiner.reference(cfg, refiner.weights(cfg, 3, "cpu", torch.float32), "cpu")
req = refiner.request(3, 0, t, "cpu")
img = ref.refine(req.images / 255.0, req.prompt, req.noise, [1], negative_prompt="",
                 strength=0.35, steps=20)
print(json.dumps({"shape": list(img.shape), "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_the_refine_reference_loads_nothing_of_the_port():
    got = _run(REFERENCE_ONLY)
    assert got["shape"] == [1, 32, 32, 3]
    assert not {"instancediffusion_tpu_torch", "instancediffusion_tpu", "jax",
                "jaxlib"} & set(got["tops"])
