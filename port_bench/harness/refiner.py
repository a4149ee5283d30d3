"""The SDXL refiner on both sides, the port's `SDXLRefinerPipeline` (the
system under test) and the plain reference (`reference/refine.py`), built
from one configuration file and the benchmark's seeded weights, and the
seeded inputs of a refine request.

As in `models.py`, the port is imported only inside the function that
builds it."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from port_bench.harness import layouts
from port_bench.harness import weights as wts
from port_bench.harness.models import HASH_TOKENIZER_ENV, _override
from port_bench.reference.config import VAEConfig
from port_bench.reference.openclip import OpenCLIPText, OpenCLIPTextConfig
from port_bench.reference.refine import Refiner
from port_bench.reference.sdxl_refiner import RefinerUNet, RefinerUNetConfig
from port_bench.reference.vae_encoder import EncodingAutoencoderKL


def ref_configs(config: dict):
    """(UNet, VAE, text tower) configurations of the reference."""
    c = config["config"]
    return (_override(RefinerUNetConfig(), c["unet"]), _override(VAEConfig(), c["autoencoder"]),
            _override(OpenCLIPTextConfig(), c["text_encoder"]))


def weights(config: dict, seed: int, device, dtype) -> dict:
    """The refiner UNet ("unet."), the VAE with its encoder ("vae.") and
    OpenCLIP-bigG ("clip."), drawn by `weights.draw`."""
    unet_cfg, vae_cfg, text_cfg = ref_configs(config)
    meta = dict(device="meta")
    groups = [wts.specs(RefinerUNet(unet_cfg, **meta), "unet."),
              wts.specs(EncodingAutoencoderKL(vae_cfg, **meta), "vae."),
              wts.specs(OpenCLIPText(text_cfg, **meta), "clip.")]
    return wts.draw(groups, seed, device, dtype)


def port(config: dict, weights: dict, dtype):
    """The port's SDXLRefinerPipeline on the benchmark's weights: its
    modules built empty, then loaded."""
    os.environ[HASH_TOKENIZER_ENV] = "1"
    from instancediffusion_tpu_torch import config as port_config
    from instancediffusion_tpu_torch.models import clip_text, sdxl_refiner, vae
    from instancediffusion_tpu_torch.pipeline_refiner import SDXLRefinerPipeline

    c = config["config"]
    meta = dict(device="meta")
    unet_cfg = _override(port_config.RefinerUNetConfig(), c["unet"])
    vae_cfg = _override(port_config.VAEConfig(), c["autoencoder"])
    text_cfg = _override(port_config.OpenCLIPTextConfig(), c["text_encoder"])
    return SDXLRefinerPipeline(
        wts.load(sdxl_refiner.RefinerUNet(unet_cfg, **meta), weights, "unet.", dtype),
        wts.load(vae.AutoencoderKL(vae_cfg, encoder=True, **meta), weights, "vae.", dtype),
        wts.load(clip_text.CLIPTextModel(text_cfg, **meta), weights, "clip.", dtype))


def reference(config: dict, weights: dict, device) -> Refiner:
    return Refiner.build(*ref_configs(config), config["config"]["diffusion"], weights, device)


@dataclasses.dataclass
class Request:
    images: np.ndarray   # (B, S, S, 3) uint8: the stage-1 images
    prompt: str
    noise: np.ndarray    # (B, S/8, S/8, 4) float32, standard normal


def request(seed: int, i: int, traffic: dict, device) -> Request:
    """Request i of a seed: every number from `layouts.rng(seed, 1, i)`,
    the images rendered on `device`."""
    gen = layouts.rng(seed, 1, i)
    b, s = traffic["num_images"], traffic["image_size"]
    phrases = [layouts.PHRASES[k] for k in gen.choice(len(layouts.PHRASES), 2, replace=False)]
    prompt = f"{' and '.join(phrases)} {layouts.SCENES[int(gen.integers(len(layouts.SCENES)))]}"
    images = stage1_images(gen, b, s, device)
    noise = gen.standard_normal((b, s // 8, s // 8, 4), dtype=np.float32)
    return Request(images, prompt, noise)


def stage1_images(gen: np.random.Generator, n: int, size: int, device,
                  freqs: int = 16, objects: int = 3) -> np.ndarray:
    """n images like the decoded 512 px outputs the cascade refines: a
    smooth background (a cosine series over `freqs` x `freqs` frequencies
    with 1/f amplitudes around a base colour, a top-to-bottom shade) and
    `objects` soft-edged ellipses of their own colour and texture, as
    (n, size, size, 3) uint8. The random numbers come from `gen`; the
    rendering runs on `device`."""
    k = np.arange(freqs)
    amp = 1.0 / (1.0 + np.hypot(k[:, None], k[None, :]))
    amp[0, 0] = 0.0
    coef = gen.standard_normal((n, 3, freqs, freqs)) * amp
    base = gen.uniform(0.25, 0.75, (n, 3))
    shade = gen.uniform(-0.2, 0.2, (n, 1))
    ell = gen.uniform(0.0, 1.0, (n, objects, 9))  # cx, cy, rx, ry, r, g, b, edge, texture

    dev = torch.device(device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    pos = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
    basis = torch.cos(torch.pi * f32(k)[:, None] * pos[None, :])           # (F, S)
    field = torch.einsum("fy,ncfg,gx->nyxc", basis, f32(coef), basis)     # (n, S, S, 3)
    field = field / field.flatten(1).std(dim=1).clamp(min=1e-6)[:, None, None, None]
    img = f32(base)[:, None, None, :] + 0.12 * field + f32(shade)[:, :, None, None] * (
        pos[None, :, None, None] - 0.5)
    e = f32(ell)
    yy, xx = pos[:, None], pos[None, :]
    for j in range(objects):
        cx, cy = e[:, j, 0, None, None], e[:, j, 1, None, None]
        rx, ry = 0.08 + 0.25 * e[:, j, 2, None, None], 0.08 + 0.25 * e[:, j, 3, None, None]
        d = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2
        edge = 0.02 + 0.1 * e[:, j, 7, None, None]
        m = torch.sigmoid((1.0 - d) / edge)[..., None]                        # (n, S, S, 1)
        colour = e[:, j, None, None, 4:7] + (0.05 + 0.15 * e[:, j, 8, None, None, None]) * field
        img = img * (1.0 - m) + colour * m
    return (img.clamp(0.0, 1.0) * 255.0).round().to(torch.uint8).cpu().numpy()
