"""DDIM sampler (counterpart of `instancediffusion_tpu/samplers/ddim.py`).

The eta-generalised single-step update over the uniform DDIM timestep
subset, with the same gate and first-conv hooks as PLMS:

    pred_x0 = (x - sqrt(1 - a_t) eps) / sqrt(a_t)
    x_prev  = sqrt(a_prev) pred_x0 + sqrt(1 - a_prev - sigma^2) eps + sigma z

The JAX package traces the gate inside one `lax.scan`; here a Python loop
hands each step its gate as a float, which gives the same result. The
per-step noise z comes from an explicit `torch.Generator` (JAX splits its
key into one key per step): the two give different numbers from the same
seed, so a caller that needs JAX's noise passes it in as `noise`. With
eta = 0 (the default) sigma is 0 and no noise is drawn.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from instancediffusion_tpu_torch.ops.schedules import (
    DiffusionSchedule,
    alpha_generator,
    make_ddim_sampling_parameters,
    make_ddim_timesteps,
)
from instancediffusion_tpu_torch.samplers.plms import ModelFn
from instancediffusion_tpu_torch.utils.logging import span


@dataclass(frozen=True)
class DDIMSchedule:
    """Per-step float32 / int32 numpy arrays in loop order (descending t)."""

    ts: np.ndarray
    a_t: np.ndarray
    a_prev: np.ndarray
    sqrt_one_minus_a_t: np.ndarray
    sigmas: np.ndarray
    gates: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.ts.shape[0])


def make_ddim_schedule(diffusion: DiffusionSchedule, num_steps: int,
                       alpha_type: list[float] | None = None,
                       eta: float = 0.0) -> DDIMSchedule:
    if diffusion.num_timesteps % num_steps != 0:
        raise ValueError(
            f"num_steps ({num_steps}) must divide {diffusion.num_timesteps}"
        )
    ddim_ts = make_ddim_timesteps("uniform", num_steps, diffusion.num_timesteps)
    sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
        diffusion.alphas_cumprod.astype(np.float64), ddim_ts, eta=eta
    )
    rev = np.arange(num_steps)[::-1]
    return DDIMSchedule(
        ts=ddim_ts[rev].astype(np.int32),
        a_t=alphas[rev].astype(np.float32),
        a_prev=np.asarray(alphas_prev)[rev].astype(np.float32),
        sqrt_one_minus_a_t=np.sqrt(1.0 - alphas[rev]).astype(np.float32),
        sigmas=np.asarray(sigmas)[rev].astype(np.float32),
        gates=alpha_generator(num_steps, alpha_type).astype(np.float32),
    )


def _sqrt32(v) -> float:
    """sqrt in float32, as the JAX scan takes it of its float32 scalars."""
    return float(np.sqrt(np.float32(v)))


def ddim_sample(model_fn: ModelFn, sched: DDIMSchedule, x_init: torch.Tensor,
                generator: torch.Generator | None = None,
                noise: list[torch.Tensor] | None = None) -> torch.Tensor:
    """x_T -> x_0 over the full schedule; returns the float32 latent.
    noise: one standard-normal tensor shaped like x_init per step (used
    where sigma > 0); otherwise it is drawn from `generator` (a generator
    on x_init's device, seeded 0 when None) at steps with sigma > 0."""
    x = x_init.float()
    b = x.shape[0]
    if noise is not None and len(noise) != sched.num_steps:
        raise ValueError(f"noise has {len(noise)} steps, the schedule {sched.num_steps}")
    for i in range(sched.num_steps):
        with span("step"):
            a_t, a_prev = float(sched.a_t[i]), float(sched.a_prev[i])
            sigma = float(sched.sigmas[i])
            t = torch.full((b,), int(sched.ts[i]), dtype=torch.long, device=x.device)
            e_t = model_fn(x, t, float(sched.gates[i])).float()
            pred_x0 = (x - float(sched.sqrt_one_minus_a_t[i]) * e_t) / _sqrt32(a_t)
            dir_xt = _sqrt32(np.float32(1.0) - np.float32(a_prev) - np.float32(sigma) ** 2) * e_t
            x = _sqrt32(a_prev) * pred_x0 + dir_xt
            if sigma > 0.0:
                if noise is not None:
                    z = noise[i].to(x.device, torch.float32)
                else:
                    if generator is None:
                        generator = torch.Generator(device=x.device).manual_seed(0)
                    z = torch.randn(x.shape, generator=generator, device=x.device)
                x = x + sigma * z
    return x
