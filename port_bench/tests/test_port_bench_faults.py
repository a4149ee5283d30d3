"""Each cell's run, with the harness's look for a card skipped, on the CPU
at tiny widths (the port's float32 plain routes, which agree with the
reference): sound, the check passes; with the timed path broken
underneath, `correct` comes out false. The faults an inference cell can
have: a sampler step that returns its state unchanged; half of the batch
left out (its images the mean of the rest); an answer altered where it is
produced. The cells run on one card, so no exchange between cards can be
left out."""

import pytest
import torch

from port_bench.drivers import generate
from port_bench.tests import tiny

CELLS = {
    "gen": (generate, lambda: tiny.run("gen", "sd15_instancediffusion", "plms50_mis036_mask_b8",
                                       steps=5, num_images=2, instances=2)),
}


def _unchanged_step(monkeypatch, cell):
    from instancediffusion_tpu_torch.samplers import plms

    monkeypatch.setattr(plms, "_x_prev", lambda x, *a: x)


def _half_batch(monkeypatch, cell):
    """The second half of every batch's images is the mean of the first."""
    from instancediffusion_tpu_torch import pipeline

    def halve(img):
        h = img.shape[0] // 2
        img = img.clone()
        img[h:] = img[:h].float().mean(0, keepdim=True).to(img.dtype)
        return img

    orig = pipeline.InstanceDiffusionPipeline._decode
    monkeypatch.setattr(pipeline.InstanceDiffusionPipeline, "_decode",
                        lambda self, z: halve(orig(self, z)))


def _altered_answer(monkeypatch, cell):
    """Every image moved one pixel where it is made."""
    from instancediffusion_tpu_torch import pipeline

    orig = pipeline.InstanceDiffusionPipeline._decode
    monkeypatch.setattr(pipeline.InstanceDiffusionPipeline, "_decode",
                        lambda self, z: torch.roll(orig(self, z), 1, dims=2))


FAULTS = {"unchanged_step": _unchanged_step, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_sound_run_is_correct(cell):
    driver, make = CELLS[cell]
    out = driver.run(make())
    assert out.correct, out.checks
    assert out.checks[0].value < 0.05  # the plain routes agree with the reference


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    driver, make = CELLS[cell]
    FAULTS[fault](monkeypatch, cell)
    out = driver.run(make())
    assert not out.correct, out.checks
