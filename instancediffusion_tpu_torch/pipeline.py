"""End-to-end InstanceDiffusion pipeline on PyTorch: demo meta -> images
(counterpart of `instancediffusion_tpu/pipeline.py`, PLMS path).

One `generate` call: one batched CLIP encode of prompt, negative prompt and
phrases; batch-1 grounding prepared on the host with deferred phrase
embeddings, the pooled CLIP rows injected on the device; UniFusion once per
call for the conditional and the null grounding; 50-step PLMS with
classifier-free guidance as one [cond | uncond] 2B UNet forward and fp32
sampler state; UniFusion in fp32; VAE decode in the compute dtype; uint8 quantisation (floor)
on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from instancediffusion_tpu_torch.config import Config
from instancediffusion_tpu_torch.data.grounding_input import DEFER_EMBEDDING, prepare_grounding
from instancediffusion_tpu_torch.data.tokenizer import CLIPTokenizer
from instancediffusion_tpu_torch.models import clip_text, unet, unifusion, vae
from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
from instancediffusion_tpu_torch.samplers.plms import make_plms_schedule, plms_sample


class InstanceDiffusionPipeline:
    def __init__(self, cfg: Config, unet_model: unet.UNet, vae_model: vae.AutoencoderKL,
                 clip_model: clip_text.CLIPTextModel, tokenizer=None):
        self.cfg = cfg
        self.unet = unet_model
        self.vae = vae_model
        self.clip = clip_model
        param = next(unet_model.parameters())
        self.device, self.dtype = param.device, param.dtype
        self.tokenizer = CLIPTokenizer.load_default() if tokenizer is None else tokenizer
        self.diffusion = make_diffusion_schedule(
            cfg.diffusion.beta_schedule, cfg.diffusion.timesteps,
            cfg.diffusion.linear_start, cfg.diffusion.linear_end,
        )

    @property
    def image_size(self) -> int:
        """Pixel size of the decoded images."""
        return self.cfg.model.image_size * 2 ** (len(self.cfg.autoencoder.ch_mult) - 1)

    @classmethod
    def random_init(cls, cfg: Config, seed: int = 0, device="cuda",
                    dtype=torch.bfloat16) -> "InstanceDiffusionPipeline":
        """Random weights (the JAX package's initialisers) drawn from a
        torch.Generator on `device`, cast to `dtype`."""
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        kw = dict(generator=gen, device=device)
        models = (unet.UNet(cfg.model, **kw), vae.AutoencoderKL(cfg.autoencoder, **kw),
                  clip_text.CLIPTextModel(cfg.text_encoder, **kw))
        for m in models:
            m.to(dtype).eval()
        return cls(cfg, *models)

    def _check_tokenizer(self):
        if getattr(self.tokenizer, "is_fallback", False):
            # refuses unless IDTPU_ALLOW_HASH_TOKENIZER=1
            self.tokenizer.require_real("prompt encoding")

    @torch.inference_mode()
    def generate(self, meta: dict, num_images: int | None = None,
                 steps: int | None = None, guidance_scale: float | None = None,
                 alpha: float | None = None, mis: float | None = None,
                 seed: int | None = None, negative_prompt: str | None = None,
                 sampler: str | None = None,
                 initial_latents: np.ndarray | None = None) -> np.ndarray:
        """meta: demo dict (prompt, phrases, locations[, points, scribbles,
        polygons, segs, alpha_type]). Returns (num_images, H, W, 3) uint8.

        Only PLMS without the Multi-Instance Sampler is ported: the
        config's default mis (0.36) therefore raises; pass mis=0.0."""
        scfg = self.cfg.sampler
        num_images = num_images or scfg.num_images
        steps = steps or scfg.steps
        gs = scfg.guidance_scale if guidance_scale is None else guidance_scale
        alpha = scfg.alpha if alpha is None else alpha
        seed = scfg.seed if seed is None else seed
        neg = scfg.negative_prompt if negative_prompt is None else negative_prompt
        sampler = scfg.sampler if sampler is None else sampler
        if sampler != "plms":
            raise NotImplementedError(
                f"sampler={sampler!r} is not ported yet (ROADMAP Queue 1 item "
                "10: DPM and DDIM); use sampler='plms'"
            )
        if mis is None:
            mis = scfg.mis
        if mis > 0:
            raise NotImplementedError(
                f"mis={mis}: the Multi-Instance Sampler is not ported yet "
                "(ROADMAP Queue 1 item 9); pass mis=0.0"
            )
        mcfg = self.cfg.model
        gcfg = mcfg.grounding_tokenizer
        dev, dt = self.device, self.dtype
        alpha_type = meta.get("alpha_type", [alpha, 0.0, 1 - alpha])
        sched = make_plms_schedule(self.diffusion, steps, alpha_type)

        # one batched text encode: prompt, negative prompt, phrases
        k = len(meta["phrases"])
        self._check_tokenizer()
        texts = [meta["prompt"], neg] + list(meta["phrases"])
        ids = np.stack([self.tokenizer.encode(t) for t in texts])
        enc = clip_text.apply_clip_text(self.clip, torch.from_numpy(ids).long().to(dev))
        context, uc = enc["last_hidden_state"][0:1], enc["last_hidden_state"][1:2]

        # batch-1 grounding; pooled phrase rows injected on the device
        g_np = prepare_grounding(meta, [DEFER_EMBEDDING] * k, batch=1,
                                 max_objs=mcfg.max_objs, in_dim=gcfg.in_dim,
                                 n_scribble_points=gcfg.n_scribble_points,
                                 n_polygon_points=gcfg.n_polygon_points,
                                 seg_size=gcfg.seg_resize_input)
        # the grounding stays fp32, so UniFusion and its ConvNeXt run in fp32
        # on the compute-dtype weights, as in the JAX pipeline (the Fourier
        # features reach frequencies of ~75 rad per unit of box coordinate)
        grounding = {key: torch.from_numpy(v).to(dev, torch.float32)
                     for key, v in g_np.items()}
        if k:
            n_slots = min(len(meta["locations"]), k, mcfg.max_objs)
            pooled = enc["pooler_output"][2:2 + k].float()
            emb = torch.zeros_like(grounding["positive_embeddings"])
            emb[0, :n_slots] = pooled[:n_slots]
            grounding["positive_embeddings"] = emb

        # UniFusion once per call (grounding tokens are timestep-invariant);
        # every image shares the meta, so one row is computed and broadcast
        drops = unifusion.ModalityDrops.test_defaults(gcfg)
        objs_c = unifusion.apply_unifusion(self.unet.position_net, gcfg, grounding, drops)
        b = num_images

        if initial_latents is not None:
            x_init = torch.as_tensor(np.asarray(initial_latents), device=dev).to(dt)
            want = (b, mcfg.image_size, mcfg.image_size, mcfg.in_channels)
            if tuple(x_init.shape) != want:
                raise ValueError(f"initial_latents shape {tuple(x_init.shape)} != {want}")
        else:
            gen = torch.Generator(device=dev).manual_seed(seed)
            x_init = torch.randn((b, mcfg.image_size, mcfg.image_size, mcfg.in_channels),
                                 generator=gen, device=dev).to(dt)

        # classifier-free guidance as one [cond | uncond] 2B forward; the
        # unconditional half takes the null grounding
        expand = lambda t: t.expand(b, *t.shape[1:])
        null_g = unifusion.null_grounding(1, mcfg.max_objs, gcfg, device=dev)
        objs_u = unifusion.apply_unifusion(self.unet.position_net, gcfg, null_g, drops)
        ctx2 = torch.cat([expand(context), expand(uc)])
        objs2 = torch.cat([expand(objs_c), expand(objs_u)])

        def model_fn(x, t, gate):
            x2 = torch.cat([x, x]).to(dt)
            eps2 = unet.apply_unet(self.unet, mcfg, x2, torch.cat([t, t]), ctx2,
                                   gate_scale=gate, precomputed_objs=objs2)
            e_cond, e_uncond = eps2.chunk(2)
            return e_uncond + gs * (e_cond - e_uncond)

        z = plms_sample(model_fn, sched, x_init)
        img = vae.vae_decode(self.vae, z.to(dt))
        # quantise on the device: [-1, 1] -> uint8 with floor (the
        # reference's numpy astype truncation)
        img = img.float().clamp(-1.0, 1.0) * 0.5 + 0.5
        return torch.floor(img * 255.0).to(torch.uint8).cpu().numpy()
