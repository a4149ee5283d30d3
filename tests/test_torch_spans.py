"""The program's spans (`instancediffusion_tpu_torch/utils/logging.span`) on
the CPU: a torch.profiler session over a tiny masked MIS `generate` records
them nested as the layers nest (request, program, sampler step, UNet
forward, fuser, attention, FF) and as many as the call makes, and a tiny
refine its VAE encode inside its program; without a session they record
nothing and leave the images and `last_timings` as they are. Also the span
breakdown of `tools/torch_span_breakdown.py` on synthetic traces, beside
the harness's own reduction of the same events."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from instancediffusion_tpu_torch.config import (
    Config,
    OpenCLIPTextConfig,
    RefinerUNetConfig,
    TextEncoderConfig,
    UNetConfig,
    UniFusionConfig,
    VAEConfig,
)
from instancediffusion_tpu_torch.models.unet import TransformerBlock
from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline
from instancediffusion_tpu_torch.pipeline_refiner import SDXLRefinerPipeline
from instancediffusion_tpu_torch.utils import logging as obs
from port_bench.harness import trace

ROOT = Path(__file__).resolve().parents[1]
STEPS, MIS = 2, 0.5  # PLMS: one MIS step (with its extra first forward), one global
META = {"prompt": "two shapes", "phrases": ["a red square", "a blue circle"],
        "locations": [[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9]],
        "points": [[0.3, 0.3], [0.75, 0.75]]}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_span_breakdown", ROOT / "tools" / "torch_span_breakdown.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pipe():
    """A tiny fp32 pipeline with instance-masked fusers, densified weights."""
    g = UniFusionConfig(in_dim=32, out_dim=32, mid_dim=32, fourier_freqs=4,
                        fourier_freqs_polygons=4, n_scribble_points=4, n_polygon_points=8,
                        seg_channels=4, seg_resize_input=64, convnext_depths=(1, 1),
                        convnext_dims=(8, 16), convnext_feature_dim=1024)
    cfg = Config(
        model=UNetConfig(image_size=8, model_channels=32, num_heads=4, context_dim=32,
                         max_objs=4, grounding_tokenizer=g, channel_mult=(1,),
                         num_res_blocks=1, attention_resolutions=(1,), use_checkpoint=False,
                         use_masked_att=True),
        autoencoder=VAEConfig(ch=32, ch_mult=(1, 2), resolution=64),
        text_encoder=TextEncoderConfig(vocab_size=512, hidden_size=32, intermediate_size=64,
                                       num_hidden_layers=2, num_attention_heads=4))
    p = InstanceDiffusionPipeline.random_init(cfg, seed=0, device="cpu", dtype=torch.float32)
    for i, m in enumerate((p.unet, p.vae, p.clip)):
        chip_smoke.densify_(m, i + 1)
    assert p._masking()
    return p


def _generate(pipe):
    return pipe.generate(META, num_images=2, steps=STEPS, mis=MIS, seed=3, sampler="plms")


def _idt_parent(ev):
    """The nearest enclosing `idt.` span of a profiler event, or None."""
    p = ev.cpu_parent
    while p is not None and not p.name.startswith(obs.SPAN_PREFIX):
        p = p.cpu_parent
    return p


def test_span_opens_no_range_without_a_session(monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or obs._OFF)
    timings = {}
    with obs.span("unet"):
        pass
    with obs.span("fetch", timings):
        pass
    with obs.span("text_encode", timings):
        pass
    assert opened == []
    assert obs.span("unet") is obs.span("step")  # one shared no-op context
    assert set(timings) == {"fetch", "text_encode"} and min(timings.values()) >= 0.0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with obs.span("unet"):
            pass
        with obs.span("fetch", timings):
            pass
    assert opened == ["idt.unet", "idt.fetch"]


def test_program_spans_nest_and_count(pipe):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _generate(pipe)
    spans = [e for e in prof.events() if e.name.startswith(obs.SPAN_PREFIX)]
    count = lambda n: sum(e.name == "idt." + n for e in spans)
    parents = {}
    for e in spans:
        p = _idt_parent(e)
        parents.setdefault(e.name, set()).add(None if p is None else p.name)
    assert parents == {
        "idt.generate": {None},
        "idt.text_encode": {"idt.generate"},
        "idt.grounding_prep": {"idt.generate"},
        "idt.sample": {"idt.generate"},
        "idt.conditioning": {"idt.sample"},
        "idt.step": {"idt.sample"},
        "idt.unet": {"idt.step"},
        "idt.fuser": {"idt.unet"},
        "idt.attn": {"idt.unet", "idt.fuser"},
        "idt.ff": {"idt.unet", "idt.fuser"},
        "idt.decode": {"idt.sample"},
        "idt.fetch": {"idt.generate"},
    }
    # one request, one program, one span a step; PLMS's first step runs two
    # forwards; the grounding rows and the null grounding each condition once
    assert count("generate") == count("sample") == count("decode") == count("fetch") == 1
    assert count("step") == STEPS and count("conditioning") == 2
    sched = pipe._make_schedule("plms", STEPS, [pipe.cfg.sampler.alpha, 0.0,
                                                1 - pipe.cfg.sampler.alpha])
    gates = [sched.gates[0]] + list(sched.gates)  # the extra first forward
    assert count("unet") == len(gates) == STEPS + 1
    blocks = sum(isinstance(m, TransformerBlock) for m in pipe.unet.modules())
    open_ = sum(g != 0 for g in gates)
    assert 0 < open_ < len(gates)  # forwards with and without the fuser
    assert count("fuser") == blocks * open_
    # self, cross, and the fuser's attention; the block's FF and the fuser's
    assert count("attn") == blocks * (2 * len(gates) + open_)
    assert count("ff") == blocks * (len(gates) + open_)


def test_refine_encodes_inside_its_program_span(monkeypatch):
    """A profiled tiny refine records `idt.encode` (the VAE encode) inside
    `idt.sample`, once; without a session it opens no range."""
    monkeypatch.setenv("IDTPU_ALLOW_HASH_TOKENIZER", "1")  # no BPE files here
    rp = SDXLRefinerPipeline.random_init(
        seed=0, device="cpu", dtype=torch.float32,
        unet_cfg=RefinerUNetConfig(image_size=4, model_channels=32, channel_mult=(1, 2),
                                   num_res_blocks=1, attention_resolutions=(2,),
                                   num_head_channels=16, transformer_depth=1, context_dim=32,
                                   adm_in_channels=32 + 5 * 256),
        text_cfg=OpenCLIPTextConfig(vocab_size=512, hidden_size=32, intermediate_size=64,
                                    num_hidden_layers=2, num_attention_heads=4,
                                    projection_dim=32),
        vae_cfg=VAEConfig(scale_factor=0.13025, ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1))
    images = np.random.default_rng(0).uniform(size=(2, 32, 32, 3)).astype(np.float32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        rp.refine(images, "a fox", strength=0.35, steps=20)
    spans = [e for e in prof.events() if e.name.startswith(obs.SPAN_PREFIX)]
    parents = {}
    for e in spans:
        p = _idt_parent(e)
        parents.setdefault(e.name, set()).add(None if p is None else p.name)
    assert parents["idt.encode"] == {"idt.sample"}
    assert parents["idt.decode"] == {"idt.sample"} and parents["idt.step"] == {"idt.sample"}
    assert sum(e.name == "idt.encode" for e in spans) == 1
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or obs._OFF)
    rp.refine(images, "a fox", strength=0.35, steps=20)
    assert opened == []


def test_no_session_same_timings_and_images(pipe):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _generate(pipe)
    traced_keys = set(pipe.last_timings)
    plain = _generate(pipe)
    assert set(pipe.last_timings) == traced_keys == {"text_encode", "grounding_prep",
                                                      "sample", "fetch"}
    np.testing.assert_array_equal(plain, traced)
    handle = pipe.generate(META, num_images=2, steps=STEPS, mis=MIS, seed=3, block=False)
    np.testing.assert_array_equal(handle.fetch(), plain)
    assert set(handle.timings) == {"text_encode", "grounding_prep", "enqueue", "dispatch",
                                   "fetch"}


class _Ev:
    """A profiler event as `events()` gives it (the harness test's stand-in)."""

    def __init__(self, name, start, dur, device=False, tid=1, corr=0):
        self._n, self._s, self._d, self._dev, self._t, self._c = name, start, dur, device, tid, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    def start_thread_id(self):
        return self._t

    def correlation_id(self):
        return self._c


def _launch(t, corr, kernel_at, kernel_dur=100, name="cudaLaunchKernel"):
    return [_Ev(name, t, 5, corr=corr),
            _Ev(f"kernel{corr}", kernel_at, kernel_dur, device=True, corr=corr)]


def test_gap_under_a_step_opened_long_before():
    """An idle gap whose middle falls under an idt.step opened more than 64
    host events earlier is put down to that step."""
    events = [_Ev("idt.step", 0, 300_000)]
    for c in range(1, 101):  # 100 launches, back to back on the card
        events += _launch(10 * c, c, kernel_at=1000 * c, kernel_dur=1000)
    events += _launch(90_000, 101, kernel_at=200_000)  # the card idles 101k-200k
    got = _tool().reduce_spans(events)
    assert got["idle_gaps"] == {"span:idt.step": pytest.approx(99e-6)}
    assert got["idle_s_by_span"] == {"idt.step": pytest.approx(99e-6)}


def test_program_spans_leave_the_harness_numbers_as_they_are():
    """busy_s and span_device_s["attn"] read the same with idt ranges around
    the benchmark's attention span, on the host and drawn on the device."""
    base = [_Ev("pb.attn", 100, 50)]
    base += _launch(110, 1, kernel_at=1000, kernel_dur=400)
    base += _launch(300, 2, kernel_at=2000, kernel_dur=300)
    base += [_Ev("pb.attn", 100, 3000, device=True, corr=1)]  # the span's device range
    program = [_Ev("idt.sample", 0, 10_000), _Ev("idt.unet", 50, 500),
               _Ev("idt.attn", 90, 100),
               _Ev("idt.sample", 0, 10_000, device=True, corr=1),
               _Ev("idt.attn", 90, 3000, device=True, corr=1)]
    a, b = trace.reduce(base, 1.0), trace.reduce(base + program, 1.0)
    assert b.busy_s == a.busy_s == pytest.approx(700e-9)
    assert b.span_device_s == a.span_device_s == {"attn": pytest.approx(400e-9)}
    got = _tool().reduce_spans(base + program)
    assert got["device_s_by_span"] == {"idt.attn": pytest.approx(400e-9),
                                       "idt.unet": pytest.approx(300e-9)}
    # the gap's middle (1700) falls under idt.sample alone
    assert got["idle_gaps"] == {"span:idt.sample": pytest.approx(600e-9)}


def test_sample_readings_count_only_inside_the_program():
    """sample_idle_s and sample_launches count the idle time and the
    enqueuing runtime calls inside idt.sample, per request."""
    events = [_Ev("idt.generate", 0, 10_000), _Ev("idt.text_encode", 10, 990),
              _Ev("idt.sample", 1_000, 5_000), _Ev("idt.fetch", 6_100, 3_000)]
    events += _launch(100, 1, kernel_at=200)                  # text encode: outside
    events += _launch(1_100, 2, kernel_at=1_200)
    events += _launch(1_200, 3, kernel_at=2_300, name="cudaMemcpyAsync")
    events += _launch(1_300, 4, kernel_at=2_400, name="cudaGraphLaunch")
    events += [_Ev("cudaStreamSynchronize", 1_400, 5, corr=5)]  # enqueues nothing
    events += _launch(5_000, 6, kernel_at=5_100, name="cuLaunchKernelEx")
    events += _launch(6_200, 7, kernel_at=9_000)               # fetch: outside
    # a second request
    events += [_Ev("idt.generate", 20_000, 10_000), _Ev("idt.sample", 21_000, 2_000)]
    events += _launch(21_100, 8, kernel_at=21_200)
    events += _launch(21_200, 9, kernel_at=22_000)
    got = _tool().reduce_spans(events)
    assert got["requests"] == 2
    assert got["sample_launches"] == pytest.approx((4 + 2) / 2)
    # gaps: 300-1200 (middle 750, text encode), 1300-2300 (1800, sample),
    # 2500-5100 (3800, sample), 5200-9000 (7100, fetch), 9100-21200 (15150,
    # between requests), 21300-22000 (21650, sample)
    assert got["sample_idle_s"] == pytest.approx((1000 + 2600 + 700) / 2 * 1e-9)
    assert got["idle_s_by_span"] == {
        "idt.sample": pytest.approx(4300e-9), "idt.fetch": pytest.approx(3800e-9),
        "idt.text_encode": pytest.approx(900e-9)}
    assert got["idle_gaps"]["host_python"] == pytest.approx(12_100e-9)
    assert got["launches_by_span"] == {"idt.sample": 6, "idt.text_encode": 1, "idt.fetch": 1}
    assert got["span_counts"]["idt.sample"] == 2


def test_span_cost_is_measured_with_and_without_a_session():
    cost = _tool().span_cost_us(200)
    assert cost["spans"] == 200 and 0 < cost["off"] and 0 < cost["on"]
    assert not torch._C._autograd._profiler_enabled()
