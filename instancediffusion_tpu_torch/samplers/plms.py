"""PLMS (pseudo linear multistep) sampler (counterpart of
`instancediffusion_tpu/samplers/plms.py`).

The JAX `lax.scan` becomes a Python loop over static-gate segments: the
gate of each step is a Python float handed to `model_fn`, so a gate-0
segment runs a UNet without the fuser. The first step is the order-1
pseudo improved Euler with its extra model call; later steps combine up to
four eps values (Adams-Bashforth). Sampler state (x, eps history) is
float32 whatever the model's compute dtype; eta is 0.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from instancediffusion_tpu_torch.ops.schedules import (
    DiffusionSchedule,
    alpha_generator,
    make_ddim_sampling_parameters,
    make_ddim_timesteps,
)

ModelFn = Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]
# model_fn(x (B,H,W,C), t (B,) int, gate float) -> eps (B,H,W,C)


@dataclass(frozen=True)
class PLMSSchedule:
    """Per-step arrays in loop order (descending t), float32 / int32 numpy."""

    ts: np.ndarray
    ts_next: np.ndarray
    a_t: np.ndarray
    a_prev: np.ndarray
    sqrt_one_minus_a_t: np.ndarray
    gates: np.ndarray

    @property
    def num_steps(self) -> int:
        return int(self.ts.shape[0])


def make_plms_schedule(diffusion: DiffusionSchedule, num_steps: int,
                       alpha_type: list[float] | None = None) -> PLMSSchedule:
    if diffusion.num_timesteps % num_steps != 0:
        raise ValueError(
            f"num_steps ({num_steps}) must divide the DDPM timestep count "
            f"({diffusion.num_timesteps})"
        )
    ddim_ts = make_ddim_timesteps("uniform", num_steps, diffusion.num_timesteps)
    _, ddim_alphas, ddim_alphas_prev = make_ddim_sampling_parameters(
        diffusion.alphas_cumprod.astype(np.float64), ddim_ts, eta=0.0
    )
    time_range = ddim_ts[::-1]
    s = len(time_range)
    idx = np.arange(s)
    rev = s - 1 - idx
    return PLMSSchedule(
        ts=time_range.astype(np.int32),
        ts_next=time_range[np.minimum(idx + 1, s - 1)].astype(np.int32),
        a_t=ddim_alphas[rev].astype(np.float32),
        a_prev=np.asarray(ddim_alphas_prev)[rev].astype(np.float32),
        sqrt_one_minus_a_t=np.sqrt(1.0 - ddim_alphas[rev]).astype(np.float32),
        gates=alpha_generator(s, alpha_type).astype(np.float32),
    )


def gate_runs(gates: np.ndarray) -> tuple:
    """Run-length encode a per-step gate array into ((value, count), ...)."""
    runs: list[list] = []
    for g in np.asarray(gates):
        g = float(g)
        if runs and runs[-1][0] == g:
            runs[-1][1] += 1
        else:
            runs.append([g, 1])
    return tuple((g, n) for g, n in runs)


def _x_prev(x, e_t, a_t, a_prev, sqrt_1m_at):
    """x_{t-1} and pred_x0 with sigma = 0; coefficients are float32 scalars."""
    pred_x0 = (x - sqrt_1m_at * e_t) / math.sqrt(a_t)
    return math.sqrt(a_prev) * pred_x0 + math.sqrt(1.0 - a_prev) * e_t


def _e_t_prime(e_t, hist):
    """Adams-Bashforth combine of e_t with up to three older eps (hist,
    newest last, at least one entry)."""
    if len(hist) == 1:
        return (3 * e_t - hist[-1]) / 2
    if len(hist) == 2:
        return (23 * e_t - 16 * hist[-1] + 5 * hist[-2]) / 12
    return (55 * e_t - 59 * hist[-1] + 37 * hist[-2] - 9 * hist[-3]) / 24


def plms_sample(model_fn: ModelFn, sched: PLMSSchedule, x_init: torch.Tensor) -> torch.Tensor:
    """Full PLMS pass over the schedule's static-gate segments; returns the
    float32 latent."""
    x = x_init.float()
    b = x.shape[0]
    hist: list[torch.Tensor] = []
    start = 0
    for gate, count in gate_runs(sched.gates):
        for i in range(start, start + count):
            a_t, a_prev = float(sched.a_t[i]), float(sched.a_prev[i])
            sqrt_1m = float(sched.sqrt_one_minus_a_t[i])
            t = torch.full((b,), int(sched.ts[i]), dtype=torch.long, device=x.device)
            e_t = model_fn(x, t, gate).float()
            if not hist:
                # pseudo improved Euler: a second model call at (x_prev, t_next)
                t_next = torch.full((b,), int(sched.ts_next[i]), dtype=torch.long,
                                    device=x.device)
                x1 = _x_prev(x, e_t, a_t, a_prev, sqrt_1m)
                e_prime = (e_t + model_fn(x1, t_next, gate).float()) / 2
            else:
                e_prime = _e_t_prime(e_t, hist)
            x = _x_prev(x, e_prime, a_t, a_prev, sqrt_1m)
            hist = (hist + [e_t])[-3:]
        start += count
    return x
