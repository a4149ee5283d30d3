"""DDIM (eta 0) with img2img timestep slicing, of the plain reference.

A `steps`-step DDIM schedule over the uniform timestep subset
(1, 1 + T/steps, ...), run from the noisiest step down; img2img keeps its
last int(steps * strength) entries (at least one: diffusers' slicing),
noises the clean latent to the first kept step's alpha, and takes the
kept steps:

    pred_x0 = (x - sqrt(1 - a_t) eps) / sqrt(a_t)
    x_prev  = sqrt(a_prev) pred_x0 + sqrt(1 - a_prev) eps

The sampler's state is float32; the schedule's scalars are float32 as the
port's are.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference.schedules import (
    DiffusionSchedule, make_ddim_sampling_parameters, make_ddim_timesteps,
)


def img2img_schedule(diffusion: DiffusionSchedule, steps: int, strength: float):
    """[(t, a_t, a_prev)] of the kept steps, noisiest first, float32."""
    keep = max(1, min(int(steps * strength), steps))
    ts = make_ddim_timesteps("uniform", steps, diffusion.num_timesteps)
    _, a_t, a_prev = make_ddim_sampling_parameters(
        diffusion.alphas_cumprod.astype(np.float64), ts, eta=0.0)
    rows = [(int(ts[i]), np.float32(a_t[i]), np.float32(a_prev[i])) for i in range(steps)]
    return rows[::-1][steps - keep:]


def _sqrt(v) -> float:
    return float(np.sqrt(np.float32(v)))


def noise_to(z: torch.Tensor, noise: torch.Tensor, a0) -> torch.Tensor:
    """The clean latent noised to alpha a0."""
    return _sqrt(a0) * z.float() + _sqrt(np.float32(1.0) - a0) * noise.float()


def ddim_sample(model_fn, schedule, x: torch.Tensor) -> torch.Tensor:
    """model_fn(x, t (B,) long) -> eps; runs every step of `schedule`."""
    x = x.float()
    for t, a_t, a_prev in schedule:
        e = model_fn(x, torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)).float()
        pred_x0 = (x - _sqrt(np.float32(1.0) - a_t) * e) / _sqrt(a_t)
        x = _sqrt(a_prev) * pred_x0 + _sqrt(np.float32(1.0) - a_prev) * e
    return x
