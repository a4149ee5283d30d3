"""End-to-end InstanceDiffusion pipeline on PyTorch: demo meta -> images
(counterpart of `instancediffusion_tpu/pipeline.py`).

One `generate` call: one batched CLIP encode of prompt, negative prompt and
phrases; batch-1 grounding rows prepared on the host with deferred phrase
embeddings, the pooled CLIP rows injected on the device; UniFusion (fp32)
once per call for the grounding rows and the null grounding; a sampler
(PLMS, DPM-Solver++(2M) or DDIM) with classifier-free guidance as one
[cond | uncond] UNet forward and fp32 sampler state, under PLMS optionally
with the Multi-Instance Sampler (`mis`), and with instance-masked fuser
attention (`use_masked_att`); VAE decode in the compute dtype; uint8
quantisation (floor) on the device.

`generate_batch` makes one image per meta in one sampling run (the serving
path, `serve.py`); `img2img` encodes an image, noises it to a mid-schedule
step and runs the rest of the PLMS schedule.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from instancediffusion_tpu_torch.config import Config
from instancediffusion_tpu_torch.data.grounding_input import (
    DEFER_EMBEDDING,
    prepare_grounding,
    prepare_instance_meta,
)
from instancediffusion_tpu_torch.data.tokenizer import CLIPTokenizer
from instancediffusion_tpu_torch.kernels.flash_attention import instance_labels
from instancediffusion_tpu_torch.models import clip_text, unet, unifusion, vae
from instancediffusion_tpu_torch.ops.instance_mask import rasterize_boxes
from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
from instancediffusion_tpu_torch.samplers.ddim import ddim_sample, make_ddim_schedule
from instancediffusion_tpu_torch.samplers.dpm import dpm_sample, make_dpm_schedule
from instancediffusion_tpu_torch.samplers.mis import mis_sample, stack_groundings
from instancediffusion_tpu_torch.samplers.plms import (
    make_plms_schedule,
    plms_sample,
    plms_steps,
)

# sampler name -> (schedule maker, sampler over a whole schedule)
_SAMPLERS = {
    "plms": (make_plms_schedule, plms_sample),
    "dpm": (make_dpm_schedule, dpm_sample),
    "ddim": (make_ddim_schedule, ddim_sample),
}


def _resolve_mis(sampler: str, mis: float | None, config_mis: float) -> float:
    """An unset mis is the config's under PLMS and 0 otherwise; MIS is a
    PLMS construction, so an explicit mis > 0 with another sampler raises."""
    if mis is None:
        return config_mis if sampler == "plms" else 0.0
    if sampler != "plms" and mis > 0:
        raise ValueError(f"sampler={sampler!r} does not support MIS (a PLMS trajectory "
                         "construction): pass mis=0.0")
    return mis


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
        # host seconds per phase of the last generate / generate_batch /
        # img2img call; "sample" ends in a device synchronize
        self.last_timings: dict = {}

    @property
    def image_size(self) -> int:
        """Pixel size of the decoded images."""
        return self.cfg.model.image_size * 2 ** (len(self.cfg.autoencoder.ch_mult) - 1)

    @classmethod
    def random_init(cls, cfg: Config, seed: int = 0, device="cuda",
                    dtype=torch.bfloat16, vae_encoder: bool = False) -> "InstanceDiffusionPipeline":
        """Random weights (the JAX package's initialisers) drawn from a
        torch.Generator on `device`, cast to `dtype`. vae_encoder: also
        build the VAE's encoder (img2img needs it)."""
        device = torch.device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        kw = dict(generator=gen, device=device)
        models = (unet.UNet(cfg.model, **kw),
                  vae.AutoencoderKL(cfg.autoencoder, encoder=vae_encoder, **kw),
                  clip_text.CLIPTextModel(cfg.text_encoder, **kw))
        for m in models:
            m.to(dtype).eval()
        return cls(cfg, *models)

    def _check_tokenizer(self):
        if getattr(self.tokenizer, "is_fallback", False):
            # refuses unless IDTPU_ALLOW_HASH_TOKENIZER=1
            self.tokenizer.require_real("prompt encoding")

    def _encode(self, texts: list[str]) -> tuple[torch.Tensor, torch.Tensor]:
        """One batched CLIP encode: (last_hidden_state, fp32 pooler_output)."""
        self._check_tokenizer()
        ids = np.stack([self.tokenizer.encode(t) for t in texts])
        enc = clip_text.apply_clip_text(self.clip, torch.from_numpy(ids).long().to(self.device))
        return enc["last_hidden_state"], enc["pooler_output"].float()

    def _make_schedule(self, sampler: str, steps: int, alpha_type):
        if sampler not in _SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}: expected 'plms' (the reference "
                             "protocol), 'dpm' (DPM-Solver++(2M)) or 'ddim'")
        return _SAMPLERS[sampler][0](self.diffusion, steps, alpha_type)

    def _grounding_row(self, meta: dict, phrase_emb: torch.Tensor) -> dict:
        """One fp32 grounding row (batch 1) on the device, with the pooled
        phrase rows `phrase_emb` (n, in_dim) injected into the first slots."""
        mcfg = self.cfg.model
        gcfg = mcfg.grounding_tokenizer
        k = len(meta["phrases"])
        g_np = prepare_grounding(meta, [DEFER_EMBEDDING] * k, batch=1,
                                 max_objs=mcfg.max_objs, in_dim=gcfg.in_dim,
                                 n_scribble_points=gcfg.n_scribble_points,
                                 n_polygon_points=gcfg.n_polygon_points,
                                 seg_size=gcfg.seg_resize_input)
        # the grounding stays fp32, so UniFusion and its ConvNeXt run in fp32
        # on the compute-dtype weights, as in the JAX pipeline (the Fourier
        # features reach frequencies of ~75 rad per unit of box coordinate)
        g = {key: torch.from_numpy(v).to(self.device, torch.float32)
             for key, v in g_np.items()}
        if k:
            n_slots = min(len(meta["locations"]), k, mcfg.max_objs)
            emb = torch.zeros_like(g["positive_embeddings"])
            emb[0, :n_slots] = phrase_emb[:n_slots]
            g["positive_embeddings"] = emb
        return g

    def _instance_labels(self, g: dict) -> tuple:
        """(bits, open) fuser labels of grounding rows: box rasters times
        the instance masks; a row without instances comes out open."""
        mcfg = self.cfg.model
        rasters = rasterize_boxes(g["boxes"], mcfg.image_size) * g["masks"][..., None, None]
        return instance_labels(rasters, mcfg.max_objs, mcfg.grounding_tokenizer.num_seg_tokens)

    def _masking(self) -> bool:
        """Instance-masked fuser attention is on and has boxes or masks."""
        mcfg = self.cfg.model
        gcfg = mcfg.grounding_tokenizer
        return mcfg.use_masked_att and not (gcfg.test_drop_boxes and gcfg.test_drop_masks)

    def _conditioning(self, g: dict):
        """(grounding tokens, labels or None) of fp32 grounding rows; UniFusion
        runs once per call (the tokens are timestep-invariant)."""
        gcfg = self.cfg.model.grounding_tokenizer
        drops = unifusion.ModalityDrops.test_defaults(gcfg)
        objs = unifusion.apply_unifusion(self.unet.position_net, gcfg, g, drops)
        return objs, (self._instance_labels(g) if self._masking() else None)

    def _null_conditioning(self, uc: torch.Tensor):
        """The CFG unconditional half, one row: the negative prompt's
        context, the null grounding's tokens and its (open) labels."""
        null_g = unifusion.null_grounding(1, self.cfg.model.max_objs,
                                          self.cfg.model.grounding_tokenizer, device=self.device)
        return (uc, *self._conditioning(null_g))

    def _cfg_model_fn(self, ctx, objs, labels, null, gs: float):
        """Classifier-free guidance over conditioning rows (one per latent
        row) as one [cond | uncond] forward; the unconditional half takes
        `null` = (context, tokens, labels) rows, broadcast."""
        n = ctx.shape[0]
        expand = lambda t: t.expand(n, *t.shape[1:])
        uc, objs_u, labels_u = null
        ctx2 = torch.cat([ctx, expand(uc)])
        objs2 = torch.cat([objs, expand(objs_u)])
        labels2 = None
        if labels is not None:
            labels2 = tuple(torch.cat([a, expand(u)]) for a, u in zip(labels, labels_u))
        mcfg, dt = self.cfg.model, self.dtype

        def model_fn(x, t, gate):
            x2 = torch.cat([x, x]).to(dt)
            eps2 = unet.apply_unet(self.unet, mcfg, x2, torch.cat([t, t]), ctx2,
                                   gate_scale=gate, precomputed_objs=objs2, fuser_mask=labels2)
            e_cond, e_uncond = eps2.chunk(2)
            return e_uncond + gs * (e_cond - e_uncond)

        return model_fn

    def _latents(self, initial_latents, b: int, seeds) -> torch.Tensor:
        """Starting noise (b, h, w, C) in the compute dtype: the caller's
        array, or standard normal draws of torch.Generators on the device:
        one seeded with `seeds` for the whole batch (an int), or one per row
        (a list)."""
        mcfg = self.cfg.model
        shape = (mcfg.image_size, mcfg.image_size, mcfg.in_channels)
        if initial_latents is not None:
            x = torch.as_tensor(np.asarray(initial_latents), device=self.device).to(self.dtype)
            if tuple(x.shape) != (b, *shape):
                raise ValueError(f"initial_latents shape {tuple(x.shape)} != {(b, *shape)}")
            return x
        randn = lambda n, s: torch.randn((n, *shape), device=self.device,
                                         generator=torch.Generator(device=self.device)
                                         .manual_seed(int(s)))
        x = randn(b, seeds) if isinstance(seeds, int) else torch.cat([randn(1, s) for s in seeds])
        return x.to(self.dtype)

    def _finish(self, z: torch.Tensor, timings: dict, t_sample: float) -> np.ndarray:
        """VAE decode and uint8 quantisation on the device ([-1, 1] ->
        uint8 with floor, the reference's numpy astype truncation); records
        the sampling and fetch times."""
        img = vae.vae_decode(self.vae, z.to(self.dtype))
        img = torch.floor((img.float().clamp(-1.0, 1.0) * 0.5 + 0.5) * 255.0).to(torch.uint8)
        if img.is_cuda:
            torch.cuda.synchronize(img.device)
        timings["sample"] = time.perf_counter() - t_sample
        t0 = time.perf_counter()
        out = img.cpu().numpy()
        timings["fetch"] = time.perf_counter() - t0
        self.last_timings = timings
        return out

    @torch.inference_mode()
    def generate(self, meta: dict, num_images: int | None = None,
                 steps: int | None = None, guidance_scale: float | None = None,
                 alpha: float | None = None, mis: float | None = None,
                 seed: int | None = None, negative_prompt: str | None = None,
                 sampler: str | None = None,
                 initial_latents: np.ndarray | None = None) -> np.ndarray:
        """meta: demo dict (prompt, phrases, locations[, points, scribbles,
        polygons, segs, alpha_type]). Returns (num_images, H, W, 3) uint8.

        sampler: 'plms' (the reference protocol), 'dpm' (DPM-Solver++(2M),
        for about 20 steps) or 'ddim'. mis: fraction of the steps run as
        Multi-Instance Sampler trajectories; unset, the config's (0.36) under
        PLMS and 0 under the others, which do not support it."""
        scfg = self.cfg.sampler
        num_images = num_images or scfg.num_images
        steps = steps or scfg.steps
        gs = scfg.guidance_scale if guidance_scale is None else guidance_scale
        alpha = scfg.alpha if alpha is None else alpha
        seed = scfg.seed if seed is None else seed
        neg = scfg.negative_prompt if negative_prompt is None else negative_prompt
        sampler = scfg.sampler if sampler is None else sampler
        mis = _resolve_mis(sampler, mis, scfg.mis)
        timings: dict = {}
        t0 = time.perf_counter()
        alpha_type = meta.get("alpha_type", [alpha, 0.0, 1 - alpha])
        sched = self._make_schedule(sampler, steps, alpha_type)
        k = len(meta["phrases"])
        mis_step = int(steps * mis) if (mis > 0 and k > 0) else 0
        num_traj = 1 + k if mis_step > 0 else 1

        # one batched text encode: prompt, negative prompt, phrases
        last, pooled_all = self._encode([meta["prompt"], neg] + list(meta["phrases"]))
        context, uc = last[0:1], last[1:2]
        pooled = pooled_all[2:2 + k]
        timings["text_encode"] = time.perf_counter() - t0

        # grounding rows: row 0 holds every instance; under MIS row j+1 is
        # instance j alone, in slot 0, with its phrase as the prompt
        t0 = time.perf_counter()
        g_rows = [self._grounding_row(meta, pooled)]
        g_rows += [self._grounding_row(prepare_instance_meta(meta, i), pooled[i:i + 1])
                   for i in range(num_traj - 1)]
        ctx_rows = torch.cat([context, last[2:2 + num_traj - 1]])
        # on the distinct rows only; every image of a row shares them
        objs_rows, labels_rows = self._conditioning(stack_groundings(g_rows))
        null = self._null_conditioning(uc)
        b = num_images
        x_init = self._latents(initial_latents, b, seed)
        timings["grounding_prep"] = time.perf_counter() - t0

        def rows_fn(rows: slice):
            """CFG over the grounding rows `rows`, each repeated for the B
            images (trajectory-major)."""
            rep = lambda t: t[rows].repeat_interleave(b, dim=0)
            labels = None if labels_rows is None else tuple(rep(a) for a in labels_rows)
            return self._cfg_model_fn(rep(ctx_rows), rep(objs_rows), labels, null, gs)

        t_sample = time.perf_counter()
        global_fn = rows_fn(slice(0, 1))
        if mis_step:
            z = mis_sample(rows_fn(slice(0, num_traj)), global_fn, sched, x_init, num_traj,
                           mis_step)
        else:
            z = _SAMPLERS[sampler][1](global_fn, sched, x_init)
        return self._finish(z, timings, t_sample)

    @torch.inference_mode()
    def generate_batch(self, metas: list[dict], steps: int | None = None,
                       guidance_scale: float | None = None, alpha: float | None = None,
                       seeds: list[int] | None = None, negative_prompt: str | None = None,
                       mis: float | None = None, sampler: str | None = None,
                       initial_latents: np.ndarray | None = None) -> np.ndarray:
        """One image per meta, every meta a row of one sampling run (the
        grounding is max_objs-padded, so different metas batch as they
        are). Row i starts from the noise of a torch.Generator seeded with
        seeds[i] (default i), or from initial_latents[i]. The gate schedule
        is [alpha, 0, 1 - alpha] for every row.

        mis > 0: every image gets the same trajectory count, 1 + the largest
        instance count rounded up to a multiple of 4 (at most max_objs);
        an image's padding trajectories take the negative prompt and the
        null grounding and are left out of its merge (traj_weights 0).
        Returns (len(metas), H, W, 3) uint8."""
        scfg = self.cfg.sampler
        steps = steps or scfg.steps
        gs = scfg.guidance_scale if guidance_scale is None else guidance_scale
        alpha = scfg.alpha if alpha is None else alpha
        neg = scfg.negative_prompt if negative_prompt is None else negative_prompt
        sampler = scfg.sampler if sampler is None else sampler
        mis = _resolve_mis(sampler, mis, scfg.mis)
        mcfg = self.cfg.model
        b = len(metas)
        if b == 0:
            raise ValueError("generate_batch needs at least one meta")
        seeds = list(range(b)) if seeds is None else [int(s) for s in seeds]
        if len(seeds) != b:
            raise ValueError(f"{len(seeds)} seeds for {b} metas")
        timings: dict = {}
        t0 = time.perf_counter()
        sched = self._make_schedule(sampler, steps, [alpha, 0.0, 1.0 - alpha])
        counts = [len(m["phrases"]) for m in metas]
        num_traj, mis_step = 1, 0
        if mis > 0 and max(counts) > 0:
            num_traj = 1 + min(mcfg.max_objs, -(-max(counts) // 4) * 4)
            mis_step = int(steps * mis)

        # one batched text encode: every prompt, the negative prompt, every
        # phrase (a MIS instance prompt is its phrase: its row is reused)
        texts = [m["prompt"] for m in metas] + [neg]
        phrase_off = []
        for m in metas:
            phrase_off.append(len(texts))
            texts += list(m["phrases"])
        last, pooled = self._encode(texts)
        timings["text_encode"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        grounding = stack_groundings([
            self._grounding_row(m, pooled[off:off + k])
            for m, off, k in zip(metas, phrase_off, counts)])
        objs, labels = self._conditioning(grounding)
        null = self._null_conditioning(last[b:b + 1])
        x_init = self._latents(initial_latents, b, seeds)
        global_fn = self._cfg_model_fn(last[:b], objs, labels, null, gs)
        traj_fn = traj_weights = None
        if num_traj > 1 and mis_step > 0:
            # trajectory-major stacks: rows [j*b, (j+1)*b) hold trajectory j
            # (trajectory 0 = the per-meta conditioning above); trajectory
            # j+1 of image i is its instance j alone, or padding
            null_row = unifusion.null_grounding(1, mcfg.max_objs, mcfg.grounding_tokenizer,
                                                device=self.device)
            rows, ctx_idx = [], list(range(b))
            for j in range(num_traj - 1):
                for i, m in enumerate(metas):
                    if j < counts[i]:
                        rows.append(self._grounding_row(
                            prepare_instance_meta(m, j),
                            pooled[phrase_off[i] + j:phrase_off[i] + j + 1]))
                        ctx_idx.append(phrase_off[i] + j)
                    else:
                        rows.append(null_row)
                        ctx_idx.append(b)  # the negative prompt's row
            objs_t, labels_t = self._conditioning(stack_groundings(rows))
            objs_s = torch.cat([objs, objs_t])
            labels_s = None if labels is None else tuple(
                torch.cat([a, t]) for a, t in zip(labels, labels_t))
            ctx_s = last[torch.as_tensor(ctx_idx, device=self.device)]
            traj_fn = self._cfg_model_fn(ctx_s, objs_s, labels_s, null, gs)
            w = np.ones((num_traj, b), np.float32)
            for i, k in enumerate(counts):
                w[1 + k:, i] = 0.0
            traj_weights = torch.from_numpy(w).to(self.device)
        timings["grounding_prep"] = time.perf_counter() - t0

        t_sample = time.perf_counter()
        if traj_fn is not None:
            z = mis_sample(traj_fn, global_fn, sched, x_init, num_traj, mis_step,
                           traj_weights=traj_weights)
        else:
            z = _SAMPLERS[sampler][1](global_fn, sched, x_init)
        return self._finish(z, timings, t_sample)

    @torch.inference_mode()
    def img2img(self, image: np.ndarray, meta: dict, strength: float = 0.5,
                num_images: int | None = None, steps: int | None = None,
                guidance_scale: float | None = None, alpha: float | None = None,
                seed: int | None = None, negative_prompt: str | None = None,
                encode_noise: np.ndarray | None = None,
                noise: np.ndarray | None = None) -> np.ndarray:
        """Instance-conditioned editing: encode `image`, noise it to the
        PLMS step that leaves `strength` of the schedule, and run the rest
        under the meta's prompt and instances (PLMS only, as the reference).

        image: (H, W, 3) or (B, H, W, 3) uint8 (or float in [-1, 1]) at the
        model resolution. encode_noise (the VAE posterior sample's) and
        noise (the forward noising's), both (num_images, h, w, 4): standard
        normals, drawn from a torch.Generator seeded with `seed` unless
        given. Needs a VAE with its encoder. Returns (num_images, H, W, 3)
        uint8."""
        scfg = self.cfg.sampler
        num_images = num_images or scfg.num_images
        steps = steps or scfg.steps
        gs = scfg.guidance_scale if guidance_scale is None else guidance_scale
        alpha = scfg.alpha if alpha is None else alpha
        seed = scfg.seed if seed is None else seed
        neg = scfg.negative_prompt if negative_prompt is None else negative_prompt
        if not 0.0 < strength <= 1.0:
            raise ValueError(f"strength must be in (0, 1], got {strength}")
        if not hasattr(self.vae, "encoder"):
            raise ValueError("img2img needs the VAE's encoder (random_init(..., "
                             "vae_encoder=True))")
        keep = max(1, min(int(steps * strength), steps))
        start = steps - keep
        mcfg = self.cfg.model
        sched = make_plms_schedule(self.diffusion, steps,
                                   meta.get("alpha_type", [alpha, 0.0, 1 - alpha]))
        img = np.asarray(image)
        if img.ndim == 3:
            img = img[None]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 127.5 - 1.0
        size = self.image_size
        if img.shape[1:3] != (size, size):
            raise ValueError(f"image must be {size}x{size} at this config, got {img.shape[1:3]}")
        if img.shape[0] == 1 and num_images > 1:
            img = np.repeat(img, num_images, axis=0)
        if img.shape[0] != num_images:
            raise ValueError(f"got {img.shape[0]} images for num_images={num_images}")

        timings: dict = {}
        t0 = time.perf_counter()
        k = len(meta["phrases"])
        last, pooled = self._encode([meta["prompt"], neg] + list(meta["phrases"]))
        timings["text_encode"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        # the context repeated per image; one grounding row for all images
        objs, labels = self._conditioning(self._grounding_row(meta, pooled[2:2 + k]))
        rep = lambda t: t.expand(num_images, *t.shape[1:])
        labels = None if labels is None else tuple(rep(a) for a in labels)
        model_fn = self._cfg_model_fn(rep(last[0:1]), rep(objs), labels,
                                      self._null_conditioning(last[1:2]), gs)
        latent = (num_images, mcfg.image_size, mcfg.image_size, mcfg.in_channels)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        draw = lambda given: (torch.randn(latent, generator=gen, device=self.device)
                              if given is None else
                              torch.as_tensor(np.array(given, np.float32), device=self.device))
        enc_noise, q_noise = draw(encode_noise), draw(noise)
        timings["grounding_prep"] = time.perf_counter() - t0

        t_sample = time.perf_counter()
        x_img = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(self.device)
        z0 = vae.vae_encode(self.vae, x_img.to(self.dtype), enc_noise.to(self.dtype)).float()
        # forward-noise to the start step's alpha (float32, as the JAX graph)
        a0 = np.float32(sched.a_t[start])
        x = float(np.sqrt(a0)) * z0 + float(np.sqrt(np.float32(1.0) - a0)) * q_noise
        z = plms_steps(model_fn, sched, x, start, sched.num_steps)[0]
        return self._finish(z, timings, t_sample)
