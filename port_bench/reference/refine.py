"""The SDXL-Refiner img2img refine of the plain reference: what one
`SDXLRefinerPipeline.refine` of the port computes, for a chosen subset of
its images, in float32 from the benchmark's weights and inputs.

The chain, as the port runs it: one OpenCLIP-bigG encode of [prompt,
negative]; the ADM vectors (the negative's pooled text with the negative
aesthetic score on the unconditional rows, the prompt's with the aesthetic
score on the conditional rows; original size the image's, crop (0, 0));
the VAE encode in mode form of images * 2 - 1; DDIM img2img from the
forward noise; classifier-free guidance as eps_u + g (eps_c - eps_u); the
VAE decode, then images * 0.5 + 0.5 clamped to [0, 1].

Each image depends only on its own rows (its stage-1 image, its noise),
so the reference refines the chosen images one at a time and gives the
numbers it would give inside the whole batch.

Departures from the published pipeline: the diffusion schedule is the one
the port runs (`config["diffusion"]` of the configuration file); the
negative prompt is encoded as text like the prompt.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from port_bench.reference import ddim, tokenizer
from port_bench.reference.config import VAEConfig
from port_bench.reference.openclip import OpenCLIPText, OpenCLIPTextConfig, apply_openclip
from port_bench.reference.schedules import make_diffusion_schedule
from port_bench.reference.sdxl_refiner import (
    RefinerUNet, RefinerUNetConfig, adm_vector, apply_refiner_unet,
)
from port_bench.reference.vae import vae_decode
from port_bench.reference.vae_encoder import EncodingAutoencoderKL, vae_encode_mode


def _load(module: torch.nn.Module, weights: dict, prefix: str, device) -> torch.nn.Module:
    """Fill a module built on the meta device with float32 copies of the
    benchmark's tensors named `prefix` + parameter name."""
    sd = {name: weights[prefix + name].to(device, torch.float32)
          for name, _ in module.named_parameters()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module.eval()


@dataclasses.dataclass
class Refiner:
    unet: RefinerUNet
    vae: EncodingAutoencoderKL
    text: OpenCLIPText
    diffusion: object

    @classmethod
    def build(cls, unet_cfg: RefinerUNetConfig, vae_cfg: VAEConfig,
              text_cfg: OpenCLIPTextConfig, diffusion: dict, weights: dict,
              device) -> "Refiner":
        meta = dict(device="meta")
        return cls(_load(RefinerUNet(unet_cfg, **meta), weights, "unet.", device),
                   _load(EncodingAutoencoderKL(vae_cfg, **meta), weights, "vae.", device),
                   _load(OpenCLIPText(text_cfg, **meta), weights, "clip.", device),
                   make_diffusion_schedule(diffusion["beta_schedule"], diffusion["timesteps"],
                                           diffusion["linear_start"], diffusion["linear_end"]))

    @property
    def device(self):
        return next(self.unet.parameters()).device

    def encode(self, texts: list[str]) -> dict:
        ids = torch.from_numpy(np.stack([tokenizer.encode(t) for t in texts])).long()
        return apply_openclip(self.text, ids.to(self.device))

    def conditioning(self, prompt: str, negative_prompt: str, size, aesthetic_score: float,
                     negative_aesthetic_score: float):
        """(context (2,77,D), y (2,2560)) of the [uncond | cond] rows."""
        enc = self.encode([prompt, negative_prompt])
        ctx = torch.cat([enc["penultimate"][1:2], enc["penultimate"][0:1]])
        y = torch.cat([adm_vector(enc["pooled"][1:2], size, (0, 0), negative_aesthetic_score),
                       adm_vector(enc["pooled"][0:1], size, (0, 0), aesthetic_score)])
        return ctx, y

    def cfg_model_fn(self, ctx, y, gs: float):
        def model_fn(x, t):
            eps = apply_refiner_unet(self.unet, torch.cat([x, x]), torch.cat([t, t]), ctx, y)
            e_u, e_c = eps.chunk(2)
            return e_u + gs * (e_c - e_u)

        return model_fn

    @torch.no_grad()
    def refine(self, images: np.ndarray, prompt: str, noise: np.ndarray, rows,
               negative_prompt: str = "", strength: float = 0.35, steps: int = 20,
               guidance_scale: float = 5.0, aesthetic_score: float = 6.0,
               negative_aesthetic_score: float = 2.5) -> np.ndarray:
        """Images `rows` of `SDXLRefinerPipeline.refine(images, prompt,
        negative_prompt, strength, steps, guidance_scale, aesthetic_score,
        negative_aesthetic_score, noise=noise)`, as (len(rows), H, W, 3)
        float32 in [0, 1]."""
        _, h, w, _ = images.shape
        ctx, y = self.conditioning(prompt, negative_prompt, (h, w), aesthetic_score,
                                   negative_aesthetic_score)
        schedule = ddim.img2img_schedule(self.diffusion, steps, strength)
        model_fn = self.cfg_model_fn(ctx, y, float(guidance_scale))
        out = []
        for r in rows:
            x_img = torch.from_numpy(np.asarray(images[r:r + 1], np.float32) * 2.0 - 1.0)
            z = vae_encode_mode(self.vae, x_img.to(self.device))
            x = ddim.noise_to(z, torch.from_numpy(np.asarray(noise[r:r + 1], np.float32))
                              .to(self.device), schedule[0][1])
            img = vae_decode(self.vae, ddim.ddim_sample(model_fn, schedule, x))
            out.append((img * 0.5 + 0.5).clamp(0.0, 1.0).cpu().numpy())
        return np.concatenate(out)
