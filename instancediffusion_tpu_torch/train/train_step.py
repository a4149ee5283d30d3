"""Training step (counterpart of `instancediffusion_tpu/train/train_step.py`).

Per step:
  1. z = VAE encode of the image, sampled, times 0.18215 (no grad)
  2. context = CLIP(caption ids) last hidden state (no grad)
  3. t = min(floor(u * 1000), 999), eps ~ N(0, 1), x_t = q_sample(z, t, eps)
  4. a 10 % whole-batch grounding drop, then the UniFusion modality drops
  5. with `use_masked_att`, fuser labels from the box rasters times the
     instance masks
  6. eps_hat = UNet(x_t, t, context, grounding), train route, gate 1.0,
     remat when `gradient_checkpointing` and `use_checkpoint`
  7. loss = fp32 MSE(eps_hat, eps); backward; optimizer, schedule and EMA
     updates on the trainable subset
A non-finite loss skips the optimizer, the schedule and the EMA, and only
`step` advances. With data parallelism (`state.dp`, `parallel/zero.py`)
one all_reduce after `loss.backward()` averages the gradients and the loss
over the ranks, so the skip is decided on the global loss, the same on
every rank; with ZeRO-1 the optimizer steps this rank's slice and one
all_gather brings the parameters back. The random draws of a step are made apart from the step
(`sample_draws`), so a caller can hand it any draws (a test hands it those
of the JAX package's recipe). Grounding and UniFusion stay fp32; the
frozen weights are bf16 after `cast_frozen_bf16` and the activations run in
the compute dtype.

Torch optimizers hold their parameters, so the optimizer and its schedule
live in the state (the JAX step takes a pure optax transform instead).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from instancediffusion_tpu_torch.config import Config
from instancediffusion_tpu_torch.kernels.flash_attention import instance_labels
from instancediffusion_tpu_torch.models import clip_text, unet, unifusion, vae
from instancediffusion_tpu_torch.ops.instance_mask import rasterize_boxes
from instancediffusion_tpu_torch.ops.schedules import DiffusionSchedule, q_sample
from instancediffusion_tpu_torch.parallel.zero import DataParallel
from instancediffusion_tpu_torch.train.optimizer import init_ema, trainable_mask, update_ema


@dataclass
class TrainState:
    step: int
    unet: unet.UNet
    # trainable-subset EMA, {parameter name: tensor}; None under ZeRO-1,
    # where `dp` holds this rank's slice of it
    ema: dict | None
    vae: vae.AutoencoderKL  # frozen, with its encoder
    clip: clip_text.CLIPTextModel  # frozen
    optimizer: torch.optim.Optimizer | None = None
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    dp: DataParallel | None = None  # data parallelism over ranks (parallel/zero.py)


@dataclass
class Draws:
    """The random numbers of one step."""

    vae_noise: torch.Tensor   # (B, h, w, 4) standard normal, the VAE sample
    t: torch.Tensor           # (B,) int64 timesteps
    noise: torch.Tensor       # (B, h, w, 4) fp32 standard normal, the target
    drop_all: bool            # the 10 % whole-batch grounding drop
    drops: unifusion.ModalityDrops


def init_train_state(cfg: Config, seed: int = 0, device="cuda") -> TrainState:
    """fp32 random weights (UNet, then VAE with its encoder, then CLIP) from
    a seeded torch.Generator on `device`; the trainable subset marked and
    copied into the EMA; no optimizer yet (`make_optimizer`)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, device=device)
    u = unet.UNet(cfg.model, **kw)
    v = vae.AutoencoderKL(cfg.autoencoder, encoder=True, **kw)
    c = clip_text.CLIPTextModel(cfg.text_encoder, **kw)
    trainable_mask(u)
    return TrainState(step=0, unet=u, ema=init_ema(u), vae=v.eval(), clip=c.eval())


def cast_frozen_bf16(state: TrainState) -> TrainState:
    """fp32 master weights only for the trainable parameters; the frozen
    UNet, the VAE and CLIP are stored bf16 (in place: the optimizer keeps
    its parameters)."""
    for p in state.unet.parameters():
        if not p.requires_grad:
            p.data = p.data.to(torch.bfloat16)
    state.vae.to(torch.bfloat16)
    state.clip.to(torch.bfloat16)
    return state


def latent_shape(cfg: Config, image_size: int) -> tuple[int, int, int]:
    f = 2 ** (len(cfg.autoencoder.ch_mult) - 1)
    return image_size // f, image_size // f, cfg.autoencoder.embed_dim


def sample_draws(generator: torch.Generator, batch_size: int, latent: tuple[int, int, int],
                 num_timesteps: int = 1000) -> Draws:
    """One step's draws from `generator`, on its device."""
    dev = generator.device
    shape = (batch_size, *latent)
    vae_noise = torch.randn(shape, generator=generator, device=dev)
    u_t = torch.rand(batch_size, generator=generator, device=dev)
    t = (u_t * num_timesteps).long().clamp_max(num_timesteps - 1)
    noise = torch.randn(shape, generator=generator, device=dev)
    u = torch.rand(7, generator=generator, device=dev).tolist()
    return Draws(vae_noise, t, noise, u[0] < 0.1, unifusion.train_modality_drops(u[1:]))


def make_loss_fn(cfg: Config, diffusion: DiffusionSchedule,
                 compute_dtype=torch.bfloat16):
    """loss_fn(state, batch, draws) -> fp32 scalar loss (not yet
    backpropagated). batch: tensors on the device, as the JAX step takes
    them (image (B,H,W,3) in [-1, 1], caption_ids (B,77), boxes, masks,
    text_embeddings, scribbles, polygons, segs, points; text_masks
    optional)."""
    mcfg = cfg.model
    gcfg = mcfg.grounding_tokenizer
    remat = cfg.train.gradient_checkpointing and mcfg.use_checkpoint

    def loss_fn(state: TrainState, batch: dict, draws: Draws) -> torch.Tensor:
        dev = draws.noise.device
        sqrt_ac = torch.as_tensor(diffusion.sqrt_alphas_cumprod, device=dev)
        sqrt_1mac = torch.as_tensor(diffusion.sqrt_one_minus_alphas_cumprod, device=dev)
        with torch.no_grad():
            z = vae.vae_encode(state.vae, batch["image"].to(compute_dtype),
                               draws.vae_noise).float()
            context = clip_text.apply_clip_text(
                state.clip, batch["caption_ids"].long())["last_hidden_state"].to(compute_dtype)
        x_t = q_sample(sqrt_ac, sqrt_1mac, z, draws.t, draws.noise).to(compute_dtype)

        grounding = {
            "boxes": batch["boxes"],
            "masks": batch["masks"],
            "text_masks": batch.get("text_masks", batch["masks"]),
            "positive_embeddings": batch["text_embeddings"],
            "scribbles": batch["scribbles"],
            "polygons": batch["polygons"],
            "segs": batch["segs"],
            "points": batch["points"],
        }
        grounding = {k: g.float() for k, g in grounding.items()}
        if draws.drop_all:
            grounding = {k: torch.zeros_like(g) for k, g in grounding.items()}
        fuser_mask = None
        if mcfg.use_masked_att:
            # under drop_all the rasters are zero: every row comes out open
            rasters = (rasterize_boxes(grounding["boxes"], mcfg.image_size)
                       * grounding["masks"][..., None, None])
            fuser_mask = instance_labels(rasters, mcfg.max_objs, gcfg.num_seg_tokens)
        eps_hat = unet.apply_unet(state.unet, mcfg, x_t, draws.t, context, grounding,
                                  gate_scale=1.0, drops=draws.drops, fuser_mask=fuser_mask,
                                  train=True, remat=remat)
        return ((eps_hat.float() - draws.noise.float()) ** 2).mean()

    return loss_fn


def make_train_step(cfg: Config, diffusion: DiffusionSchedule,
                    compute_dtype=torch.bfloat16):
    """train_step(state, batch, draws) -> (state, {"loss", "skipped"}); it
    updates the state in place (parameters, optimizer, schedule, EMA,
    step) and leaves no gradients behind."""
    loss_fn = make_loss_fn(cfg, diffusion, compute_dtype)
    ema_rate = cfg.train.ema_rate

    def train_step(state: TrainState, batch: dict, draws: Draws):
        dp = state.dp
        loss = loss_fn(state, batch, draws)
        loss.backward()
        if dp is not None:
            loss = dp.all_reduce(loss)  # the global mean loss, averaged gradients
        ok = bool(torch.isfinite(loss))
        if ok:
            if dp is not None:
                dp.load_grads()
            else:
                # a trainable parameter this step did not reach (a dropped
                # modality) takes a zero gradient, as in JAX and under data
                # parallelism: its moments decay and its step count advances
                for group in state.optimizer.param_groups:
                    for p in group["params"]:
                        if p.grad is None:
                            p.grad = torch.zeros_like(p)
            state.optimizer.step()
            if state.scheduler is not None:
                state.scheduler.step()
            if dp is not None and dp.zero1:
                dp.finish_step(ema_rate)
            else:
                update_ema(state.ema, state.unet, ema_rate)
        state.optimizer.zero_grad(set_to_none=True)
        if dp is not None:
            dp.zero_grad()
        state.step += 1
        return state, {"loss": loss.detach(), "skipped": not ok}

    return train_step
