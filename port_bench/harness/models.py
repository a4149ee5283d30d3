"""The model on both sides: the port's pipeline (the system under test) and
the plain reference, built from one configuration file and the
benchmark's seeded weights (`weights.py`).

Only this module and the drivers import the port, and only inside the
functions that build it, so the reference and the CPU dry runs never load
it by accident."""

from __future__ import annotations

import dataclasses
import os

import torch

from port_bench.harness import weights as wts
from port_bench.reference import config as ref_config
from port_bench.reference import pipeline as ref_pipeline

HASH_TOKENIZER_ENV = "IDTPU_ALLOW_HASH_TOKENIZER"


def _override(cfg, updates: dict):
    """A dataclass config with the file's values, nested, lists as tuples."""
    kw = {}
    for name, val in updates.items():
        cur = getattr(cfg, name)
        if dataclasses.is_dataclass(cur):
            kw[name] = _override(cur, val)
        elif isinstance(cur, tuple):
            kw[name] = tuple(val)
        else:
            kw[name] = val
    return dataclasses.replace(cfg, **kw)


def _request_options(cfg, traffic: dict):
    """The traffic's grounding preset and instance-masked attention."""
    gt = dataclasses.replace(cfg.model.grounding_tokenizer,
                             **ref_config.TEST_PRESETS[traffic.get("preset", "box")])
    model = dataclasses.replace(cfg.model, grounding_tokenizer=gt,
                                use_masked_att=bool(traffic.get("use_masked_att", False)))
    return dataclasses.replace(cfg, model=model)


def sd15_ref_config(config: dict, traffic: dict) -> ref_config.Config:
    return _request_options(_override(ref_config.Config(), config["config"]), traffic)


def sd15_weights(config: dict, seed: int, device, dtype) -> dict:
    cfg = _override(ref_config.Config(), config["config"])
    meta = dict(device="meta")
    groups = [wts.specs(ref_pipeline.UNet(cfg.model, **meta), "unet."),
              wts.specs(ref_pipeline.vae.AutoencoderKL(cfg.autoencoder, **meta), "vae."),
              wts.specs(ref_pipeline.clip_text.CLIPTextModel(cfg.text_encoder, **meta), "clip.")]
    return wts.draw(groups, seed, device, dtype)


def sd15_port(config: dict, traffic: dict, weights: dict, device, dtype):
    """The port's InstanceDiffusionPipeline on the benchmark's weights."""
    os.environ[HASH_TOKENIZER_ENV] = "1"
    from instancediffusion_tpu_torch import config as port_config
    from instancediffusion_tpu_torch.models import clip_text, unet, vae
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline

    cfg = _request_options(_override(port_config.Config(), config["config"]), traffic)
    meta = dict(device="meta")
    return InstanceDiffusionPipeline(
        cfg, wts.load(unet.UNet(cfg.model, **meta), weights, "unet.", dtype),
        wts.load(vae.AutoencoderKL(cfg.autoencoder, **meta), weights, "vae.", dtype),
        wts.load(clip_text.CLIPTextModel(cfg.text_encoder, **meta), weights, "clip.", dtype))


def sd15_reference(config: dict, traffic: dict, weights: dict, device) -> ref_pipeline.SD15:
    return ref_pipeline.SD15.build(sd15_ref_config(config, traffic), weights, device)


def free_cuda() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
