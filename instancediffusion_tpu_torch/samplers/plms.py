"""PLMS (pseudo linear multistep) sampler (counterpart of
`instancediffusion_tpu/samplers/plms.py`).

The JAX `lax.scan` becomes a Python loop: the gate of each step is a
Python float handed to `model_fn`, so a gate-0 step runs a UNet without the
fuser. A pass with no eps history starts with the order-1 pseudo improved
Euler step and its extra model call; later steps combine up to four eps
values (Adams-Bashforth). `plms_steps` runs a range of steps and can resume
with a history (the Multi-Instance Sampler's phase 2 does). Sampler state
(x, eps history) is float32 whatever the model's compute dtype; eta is 0.
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
from instancediffusion_tpu_torch.utils.logging import span

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


def plms_steps(model_fn: ModelFn, sched: PLMSSchedule, x: torch.Tensor, start: int,
               stop: int, hist: list[torch.Tensor] | None = None,
               assume_history: bool = False) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """PLMS steps [start, stop) from x. hist: eps history to resume with
    (newest last; the last three are used). Without history the first step
    is the order-1 pseudo improved Euler with its extra model call;
    assume_history: the caller promises a history (raises without one), so
    no order-1 step runs. Returns the float32 x and the history."""
    x = x.float()
    hist = [] if hist is None else [e.float() for e in hist][-3:]
    if assume_history and not hist:
        raise ValueError("plms_steps: assume_history without an eps history")
    b = x.shape[0]
    for i in range(start, stop):
        with span("step"):
            gate = float(sched.gates[i])
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
    return x, hist


def plms_sample(model_fn: ModelFn, sched: PLMSSchedule, x_init: torch.Tensor) -> torch.Tensor:
    """Full PLMS pass; returns the float32 latent."""
    return plms_steps(model_fn, sched, x_init, 0, sched.num_steps)[0]
