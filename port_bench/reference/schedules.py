"""Diffusion schedule math and positional/Fourier embeddings
(counterpart of `instancediffusion_tpu/ops/schedules.py`).

The schedule functions are host-side NumPy, copied from the JAX package so
the port imports no JAX; the embeddings are torch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def make_beta_schedule(schedule, n_timestep, linear_start=1e-4,
                       linear_end=2e-2, cosine_s=8e-3) -> np.ndarray:
    """Return float64 betas of shape (n_timestep,)."""
    if schedule == "linear":
        betas = np.linspace(linear_start**0.5, linear_end**0.5, n_timestep,
                            dtype=np.float64) ** 2
    elif schedule == "cosine":
        timesteps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(timesteps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        betas = np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    elif schedule == "sqrt_linear":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64)
    elif schedule == "sqrt":
        betas = np.linspace(linear_start, linear_end, n_timestep, dtype=np.float64) ** 0.5
    else:
        raise ValueError(f"schedule '{schedule}' unknown.")
    return betas


def make_ddim_timesteps(ddim_discr_method, num_ddim_timesteps,
                        num_ddpm_timesteps) -> np.ndarray:
    """Uniform/quadratic DDIM timestep subset, shifted by +1 (int array)."""
    if ddim_discr_method == "uniform":
        c = num_ddpm_timesteps // num_ddim_timesteps
        ddim_timesteps = np.asarray(list(range(0, num_ddpm_timesteps, c)))
    elif ddim_discr_method == "quad":
        ddim_timesteps = (
            np.linspace(0, np.sqrt(num_ddpm_timesteps * 0.8), num_ddim_timesteps) ** 2
        ).astype(int)
    else:
        raise NotImplementedError(
            f'There is no ddim discretization method called "{ddim_discr_method}"'
        )
    return ddim_timesteps + 1


def make_ddim_sampling_parameters(alphacums, ddim_timesteps, eta):
    """(sigmas, alphas, alphas_prev) for the selected DDIM subset."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.asarray([alphacums[0]] + alphacums[ddim_timesteps[:-1]].tolist())
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) * (1 - alphas / alphas_prev))
    return sigmas, alphas, alphas_prev


@dataclass(frozen=True)
class DiffusionSchedule:
    """The forward-process buffers the samplers and the training step read,
    float32 (T,)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    sqrt_alphas_cumprod: np.ndarray
    sqrt_one_minus_alphas_cumprod: np.ndarray

    @property
    def num_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_diffusion_schedule(beta_schedule="linear", timesteps=1000,
                            linear_start=1e-4, linear_end=2e-2,
                            cosine_s=8e-3) -> DiffusionSchedule:
    betas = make_beta_schedule(beta_schedule, timesteps, linear_start,
                               linear_end, cosine_s)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    f32 = lambda x: np.asarray(x, dtype=np.float32)
    return DiffusionSchedule(
        betas=f32(betas), alphas_cumprod=f32(alphas_cumprod),
        sqrt_alphas_cumprod=f32(np.sqrt(alphas_cumprod)),
        sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - alphas_cumprod)),
    )


def alpha_generator(length: int, type: list[float] | None = None) -> np.ndarray:
    """Per-step gate scale: `type=[a,b,c]` fractions of steps at alpha=1,
    linear decay, and alpha=0 respectively."""
    if type is None:
        type = [1, 0, 0]
    if len(type) != 3 or abs(sum(type) - 1) >= 1e-9:
        raise ValueError(f"alpha_type {type} must be 3 fractions summing to 1")
    stage0_length = int(type[0] * length)
    stage1_length = int(type[1] * length)
    stage2_length = length - stage0_length - stage1_length
    if stage1_length != 0:
        decay_alphas = list(np.arange(start=0, stop=1, step=1 / stage1_length)[::-1])
    else:
        decay_alphas = []
    alphas = [1.0] * stage0_length + decay_alphas + [0.0] * stage2_length
    return np.asarray(alphas, dtype=np.float32)


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period=10000):
    """Sinusoidal timestep embeddings, layout [cos | sin]; (B,) -> (B, dim)
    float32."""
    half = dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=timesteps.device)
    freqs = torch.exp(-math.log(max_period) * ar / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def fourier_embed(x: torch.Tensor, num_freqs: int, temperature=100.0):
    """(..., D) -> (..., F*2*D) laid out [sin(f0 x), cos(f0 x), sin(f1 x), ...]."""
    ar = torch.arange(num_freqs, dtype=torch.float32, device=x.device)
    freqs = temperature ** (ar / num_freqs)
    xb = x.float()[..., None, None, :] * freqs[:, None, None]
    out = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-2)
    return out.reshape(*x.shape[:-1], num_freqs * 2 * x.shape[-1])
