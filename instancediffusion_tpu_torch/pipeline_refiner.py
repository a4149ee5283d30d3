"""SDXL-Refiner img2img pipeline, the cascade's second stage (counterpart of
`instancediffusion_tpu/pipeline_refiner.py`).

`refine` encodes the stage-1 images (VAE mode, scale 0.13025), noises them
to `strength` of a DDIM schedule, denoises with the refiner UNet under
classifier-free guidance as one [uncond | cond] forward, and decodes.
Conditioning follows the SDXL report: cross-attention over OpenCLIP-bigG
penultimate hidden states; the ADM vector is the projected pooled text
followed by the sinusoidal embeddings of the image size, the crop and the
aesthetic score (6.0 on the conditional rows, 2.5 on the unconditional).

The forward noise comes from a `torch.Generator` seeded with `seed` (the
JAX package draws `normal(PRNGKey(seed))`: other numbers from the same
seed), unless the caller passes it as `noise`. Weights and compute are bf16
on the card, float32 on the CPU (`pipeline.default_dtype`).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from instancediffusion_tpu_torch.config import (
    OpenCLIPTextConfig, RefinerUNetConfig, VAEConfig,
)
from instancediffusion_tpu_torch.data.tokenizer import CLIPTokenizer
from instancediffusion_tpu_torch.models import clip_text, vae
from instancediffusion_tpu_torch.models.sdxl_refiner import (
    RefinerUNet, apply_refiner_unet, refiner_adm_vector,
)
from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
from instancediffusion_tpu_torch.samplers.ddim import (
    DDIMSchedule, ddim_sample, make_ddim_schedule,
)
from instancediffusion_tpu_torch.utils.logging import span, spanned

REFINER_VAE = VAEConfig(scale_factor=0.13025)  # SDXL's VAE: the SD architecture


def _slice_schedule(sched: DDIMSchedule, keep: int) -> DDIMSchedule:
    """Keep the last `keep` (lowest-noise) entries of a reversed DDIM
    schedule: diffusers' img2img timestep slicing."""
    sl = slice(sched.num_steps - keep, None)
    return dataclasses.replace(
        sched, ts=sched.ts[sl], a_t=sched.a_t[sl], a_prev=sched.a_prev[sl],
        sqrt_one_minus_a_t=sched.sqrt_one_minus_a_t[sl], sigmas=sched.sigmas[sl],
        gates=sched.gates[sl])


class SDXLRefinerPipeline:
    def __init__(self, unet_model: RefinerUNet, vae_model: vae.AutoencoderKL,
                 text_model: clip_text.CLIPTextModel, tokenizer=None):
        if not hasattr(vae_model, "encoder"):
            raise ValueError("the refiner encodes its input: build the VAE with encoder=True")
        self.unet, self.vae, self.text = unet_model, vae_model, text_model
        self.cfg, self.vae_cfg, self.text_cfg = unet_model.cfg, vae_model.cfg, text_model.cfg
        param = next(unet_model.parameters())
        self.device, self.dtype = param.device, param.dtype
        self.tokenizer = CLIPTokenizer.load_default() if tokenizer is None else tokenizer
        self.diffusion = make_diffusion_schedule()
        # host seconds of the last refine: text_encode, then sample (VAE
        # encode, the DDIM steps and the decode, ending in the copy to host)
        self.last_timings: dict = {}

    @classmethod
    def random_init(cls, seed: int = 0, device="cuda", dtype=torch.bfloat16,
                    unet_cfg: RefinerUNetConfig | None = None,
                    text_cfg: OpenCLIPTextConfig | None = None,
                    vae_cfg: VAEConfig | None = None) -> "SDXLRefinerPipeline":
        """Random weights (the JAX package's initialisers) drawn from a
        torch.Generator on `device`, cast to `dtype`; the published widths
        unless configs are given."""
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        kw = dict(generator=gen, device=device)
        models = (RefinerUNet(unet_cfg or RefinerUNetConfig(), **kw),
                  vae.AutoencoderKL(vae_cfg or REFINER_VAE, encoder=True, **kw),
                  clip_text.CLIPTextModel(text_cfg or OpenCLIPTextConfig(), **kw))
        for m in models:
            m.to(dtype).eval()
        return cls(*models)

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda",
                        dtype=torch.bfloat16) -> "SDXLRefinerPipeline":
        """Weights from `sd_xl_refiner_1.0.safetensors` (or a torch file of
        the same sgm layout) at the published widths, through
        `io/torch_convert`; a key the file lacks raises KeyError."""
        from instancediffusion_tpu_torch.io import torch_convert as tc
        from instancediffusion_tpu_torch.io.jax_params import load_jax_params

        parts = tc.split_refiner_ckpt(tc.load_torch_checkpoint(path))
        pipe = cls.random_init(seed=0, device=device, dtype=dtype)
        load_jax_params(pipe, unet=tc.convert_refiner_unet(parts["unet"], pipe.cfg),
                        vae=tc.convert_vae(parts["vae"], pipe.vae_cfg),
                        text=tc.convert_openclip_text(parts["text"], pipe.text_cfg))
        return pipe

    def _encode(self, prompts: list[str]) -> tuple[torch.Tensor, torch.Tensor]:
        """(penultimate hidden states, projected pooled text) of the prompts."""
        if getattr(self.tokenizer, "is_fallback", False):
            # refuses unless IDTPU_ALLOW_HASH_TOKENIZER=1
            self.tokenizer.require_real("refiner prompt encoding")
        ids = np.stack([self.tokenizer.encode(p) for p in prompts])
        out = clip_text.apply_clip_text(self.text, torch.from_numpy(ids).long().to(self.device))
        return out["penultimate_hidden_state"], out["projected_pooled"]

    @torch.inference_mode()
    @spanned("generate")
    def refine(self, images: np.ndarray, prompt: str, negative_prompt: str = "",
               strength: float = 0.35, steps: int = 20, guidance_scale: float = 5.0,
               aesthetic_score: float = 6.0, negative_aesthetic_score: float = 2.5,
               seed: int = 0, noise: np.ndarray | None = None) -> np.ndarray:
        """images (B, H, W, 3) float in [0, 1] -> refined (B, H, W, 3) float32
        in [0, 1]. Keeps int(steps * strength) (at least 1) of a `steps`-step
        DDIM schedule, the reference cascade's 20 steps at its strength.
        noise: the forward noise (B, H/8, W/8, 4), standard normal; drawn
        from a generator seeded with `seed` when not given."""
        b, h, w, _ = images.shape
        keep = max(1, min(int(steps * strength), steps))
        sched = _slice_schedule(make_ddim_schedule(self.diffusion, steps), keep)
        timings: dict = {}
        with span("text_encode", timings):
            # one encode of [prompt, negative]; every image takes the same rows
            ctx, pooled = self._encode([prompt, negative_prompt])
            rep = lambda t: t.expand(b, *t.shape[1:])
            ctx2 = torch.cat([rep(ctx[1:2]), rep(ctx[0:1])]).to(self.dtype)
            y = torch.cat([
                refiner_adm_vector(rep(pooled[1:2]), (h, w), (0, 0), negative_aesthetic_score),
                refiner_adm_vector(rep(pooled[0:1]), (h, w), (0, 0), aesthetic_score),
            ]).to(self.dtype)

        # "sample": the seconds from here to the images on the host (the
        # noise draw, the upload, the program and its copy back)
        t0 = time.perf_counter()
        latent = (b, h // 8, w // 8, 4)
        if noise is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            noise_t = torch.randn(latent, generator=gen, device=self.device)
        else:
            noise_t = torch.as_tensor(np.array(noise, np.float32), device=self.device)
        x_img = torch.from_numpy(np.asarray(images, np.float32) * 2.0 - 1.0).to(self.device)
        gs = float(guidance_scale)

        def model_fn(xt, t, gate):
            with span("unet"):
                x2 = torch.cat([xt, xt]).to(self.dtype)
                eps = apply_refiner_unet(self.unet, x2, torch.cat([t, t]), ctx2, y)
                e_u, e_c = eps[:b], eps[b:]
                return e_u + gs * (e_c - e_u)

        with span("sample"):
            with span("encode"):
                z = vae.vae_encode_mode(self.vae, x_img.to(self.dtype)).float()
            a0 = np.float32(sched.a_t[0])
            x = float(np.sqrt(a0)) * z + float(np.sqrt(np.float32(1.0) - a0)) * noise_t
            x0 = ddim_sample(model_fn, sched, x)
            with span("decode"):
                img = vae.vae_decode(self.vae, x0.to(self.dtype))
                img = (img.float() * 0.5 + 0.5).clamp(0.0, 1.0)
        with span("fetch"):
            out = img.cpu().numpy()
        timings["sample"] = time.perf_counter() - t0
        self.last_timings = timings
        return out
