"""Request-level functions of the plain reference: what one `generate` of
the port computes, for a chosen subset of its images, in float32 from the
benchmark's weights and inputs.

Each image of a request depends only on its own rows (its noise, its
trajectories, its half of classifier-free guidance), so the reference
computes the sampled images alone, one at a time, and gives the same
numbers it would give inside the whole batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from port_bench.reference import clip_text, tokenizer, unifusion, vae
from port_bench.reference.attention import instance_labels
from port_bench.reference.config import Config
from port_bench.reference.grounding_input import (
    DEFER_EMBEDDING, prepare_grounding, prepare_instance_meta,
)
from port_bench.reference.instance_mask import rasterize_boxes
from port_bench.reference.mis import mis_sample, stack_groundings
from port_bench.reference.plms import make_plms_schedule, plms_sample
from port_bench.reference.schedules import make_diffusion_schedule
from port_bench.reference.unet import UNet, apply_unet

_SAMPLERS = {"plms": (make_plms_schedule, plms_sample)}


def _load(module: torch.nn.Module, weights: dict, prefix: str, device) -> torch.nn.Module:
    """Fill a module built on the meta device with float32 copies of the
    benchmark's tensors named `prefix` + parameter name."""
    sd = {name: weights[prefix + name].to(device, torch.float32)
          for name, _ in module.named_parameters()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module.eval()


@dataclasses.dataclass
class SD15:
    cfg: Config
    unet: UNet
    vae: vae.AutoencoderKL
    clip: clip_text.CLIPTextModel

    @classmethod
    def build(cls, cfg: Config, weights: dict, device) -> "SD15":
        meta = dict(device="meta")
        return cls(cfg, _load(UNet(cfg.model, **meta), weights, "unet.", device),
                   _load(vae.AutoencoderKL(cfg.autoencoder, **meta), weights, "vae.", device),
                   _load(clip_text.CLIPTextModel(cfg.text_encoder, **meta), weights, "clip.",
                         device))

    @property
    def device(self):
        return next(self.unet.parameters()).device

    def encode(self, texts: list[str]):
        ids = torch.from_numpy(np.stack([tokenizer.encode(t) for t in texts])).long()
        out = clip_text.apply_clip_text(self.clip, ids.to(self.device))
        return out["last_hidden_state"], out["pooler_output"]

    def grounding_row(self, meta: dict, phrase_emb: torch.Tensor) -> dict:
        mcfg = self.cfg.model
        gcfg = mcfg.grounding_tokenizer
        k = len(meta["phrases"])
        g_np = prepare_grounding(meta, [DEFER_EMBEDDING] * k, batch=1, max_objs=mcfg.max_objs,
                                 in_dim=gcfg.in_dim, n_scribble_points=gcfg.n_scribble_points,
                                 n_polygon_points=gcfg.n_polygon_points,
                                 seg_size=gcfg.seg_resize_input)
        g = {key: torch.from_numpy(v).float().to(self.device) for key, v in g_np.items()}
        if k:
            n_slots = min(len(meta["locations"]), k, mcfg.max_objs)
            emb = torch.zeros_like(g["positive_embeddings"])
            emb[0, :n_slots] = phrase_emb[:n_slots]
            g["positive_embeddings"] = emb
        return g

    def conditioning(self, g: dict):
        mcfg = self.cfg.model
        gcfg = mcfg.grounding_tokenizer
        objs = unifusion.apply_unifusion(self.unet.position_net, gcfg, g,
                                         unifusion.ModalityDrops.test_defaults(gcfg))
        labels = None
        if mcfg.use_masked_att and not (gcfg.test_drop_boxes and gcfg.test_drop_masks):
            rasters = rasterize_boxes(g["boxes"], mcfg.image_size) * g["masks"][..., None, None]
            labels = instance_labels(rasters, mcfg.max_objs, gcfg.num_seg_tokens)
        return objs, labels

    def cfg_model_fn(self, ctx, objs, labels, uc, gs: float):
        """Classifier-free guidance as one [cond | uncond] forward; the
        unconditional half takes the negative prompt and the null
        grounding."""
        mcfg = self.cfg.model
        null_g = unifusion.null_grounding(1, mcfg.max_objs, mcfg.grounding_tokenizer,
                                          device=self.device)
        objs_u, labels_u = self.conditioning(null_g)
        n = ctx.shape[0]
        expand = lambda t: t.expand(n, *t.shape[1:])
        ctx2 = torch.cat([ctx, expand(uc)])
        objs2 = torch.cat([objs, expand(objs_u)])
        labels2 = None if labels is None else tuple(
            torch.cat([a, expand(u)]) for a, u in zip(labels, labels_u))

        def model_fn(x, t, gate):
            eps2 = apply_unet(self.unet, mcfg, torch.cat([x, x]), torch.cat([t, t]), ctx2,
                              gate_scale=gate, precomputed_objs=objs2, fuser_mask=labels2)
            e_cond, e_uncond = eps2.chunk(2)
            return e_uncond + gs * (e_cond - e_uncond)

        return model_fn

    def decode(self, z: torch.Tensor) -> np.ndarray:
        img = vae.vae_decode(self.vae, z)
        q = torch.floor((img.float().clamp(-1.0, 1.0) * 0.5 + 0.5) * 255.0).to(torch.uint8)
        return q.cpu().numpy()

    @torch.no_grad()
    def generate(self, meta: dict, num_images: int, steps: int, sampler: str, mis: float,
                 seed: int, rows, guidance_scale: float | None = None,
                 alpha: float | None = None, negative_prompt: str | None = None) -> np.ndarray:
        """Images `rows` of `InstanceDiffusionPipeline.generate(meta,
        num_images, steps, sampler=sampler, mis=mis, seed=seed)`, as
        (len(rows), H, W, 3) uint8."""
        scfg = self.cfg.sampler
        gs = scfg.guidance_scale if guidance_scale is None else guidance_scale
        alpha = scfg.alpha if alpha is None else alpha
        neg = scfg.negative_prompt if negative_prompt is None else negative_prompt
        diffusion = make_diffusion_schedule(
            self.cfg.diffusion.beta_schedule, self.cfg.diffusion.timesteps,
            self.cfg.diffusion.linear_start, self.cfg.diffusion.linear_end)
        sched = _SAMPLERS[sampler][0](diffusion, steps,
                                      meta.get("alpha_type", [alpha, 0.0, 1 - alpha]))
        k = len(meta["phrases"])
        mis_step = int(steps * mis) if (mis > 0 and k > 0) else 0
        num_traj = 1 + k if mis_step > 0 else 1

        last, pooled_all = self.encode([meta["prompt"], neg] + list(meta["phrases"]))
        pooled = pooled_all[2:2 + k]
        g_rows = [self.grounding_row(meta, pooled)]
        g_rows += [self.grounding_row(prepare_instance_meta(meta, i), pooled[i:i + 1])
                   for i in range(num_traj - 1)]
        ctx_rows = torch.cat([last[0:1], last[2:2 + num_traj - 1]])
        objs_rows, labels_rows = self.conditioning(stack_groundings(g_rows))
        mcfg = self.cfg.model
        shape = (num_images, mcfg.image_size, mcfg.image_size, mcfg.in_channels)
        x_all = torch.randn(shape, device=self.device,
                            generator=torch.Generator(device=self.device).manual_seed(int(seed)))
        out = []
        for r in rows:
            x_init = x_all[r:r + 1]

            def rows_fn(sl: slice):
                labels = None if labels_rows is None else tuple(a[sl] for a in labels_rows)
                return self.cfg_model_fn(ctx_rows[sl], objs_rows[sl], labels, last[1:2], gs)

            global_fn = rows_fn(slice(0, 1))
            if mis_step:
                z = mis_sample(rows_fn(slice(0, num_traj)), global_fn, sched, x_init, num_traj,
                               mis_step)
            else:
                z = _SAMPLERS[sampler][1](global_fn, sched, x_init)
            out.append(self.decode(z))
        return np.concatenate(out)
