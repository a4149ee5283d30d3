"""DPM-Solver++(2M) sampler (counterpart of `instancediffusion_tpu/samplers/dpm.py`).

The serving sampler: the same UNet, CFG and gate schedule as PLMS, with
the DPM-Solver++ (Lu et al. 2022) multistep update, so 20 steps stand in
for PLMS's 50. In data prediction with alpha_t = sqrt(alphas_cumprod),
sigma_t = sqrt(1 - alphas_cumprod), lambda_t = log(alpha_t / sigma_t):

    x0_i    = (x_i - sigma_i * eps(x_i, t_i)) / alpha_i
    D_i     = x0_i + (x0_i - x0_{i-1}) / (2 r_i)      [first step: x0_i]
    x_{i+1} = (sigma_{i+1} / sigma_i) x_i - alpha_{i+1} expm1(-h_i) D_i

h_i = lambda_{i+1} - lambda_i and r_i = h_{i-1} / h_i depend only on the
timestep subset: they are computed on the host in float64 and cast to
float32. Step 0 is peeled (no history, first order). The JAX package runs
one `lax.scan` per run of equal gates so that each gate is static; here a
Python loop hands every step its gate as a float, which runs the same
steps in the same order. `lower_order_final` (a first-order last step)
defaults to fewer than 15 steps. Sampler state is float32 whatever the
model's compute dtype.
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
class DPMSchedule:
    """Per-step float32 / int32 numpy arrays in loop order (i = 0 noisiest)."""

    ts: np.ndarray          # current timesteps (model input)
    alpha_s: np.ndarray     # sqrt(a_t) at the current step
    sigma_s: np.ndarray     # sqrt(1 - a_t)
    sig_ratio: np.ndarray   # sigma_{t+1} / sigma_t
    amul: np.ndarray        # -alpha_{t+1} * expm1(-h_i)  (>= 0)
    r: np.ndarray           # h_{i-1} / h_i (r[0] unused)
    gates: np.ndarray       # gated self-attention scale per step

    @property
    def num_steps(self) -> int:
        return int(self.ts.shape[0])


def make_dpm_schedule(diffusion: DiffusionSchedule, num_steps: int,
                      alpha_type: list[float] | None = None) -> DPMSchedule:
    """The uniform DDIM timestep subset (as PLMS and DDIM, so the gates line
    up step for step), as DPM-Solver++ log-SNR coefficients."""
    if diffusion.num_timesteps % num_steps != 0:
        raise ValueError(
            f"num_steps ({num_steps}) must divide the DDPM timestep count "
            f"({diffusion.num_timesteps})"
        )
    ddim_ts = make_ddim_timesteps("uniform", num_steps, diffusion.num_timesteps)
    _, alphas, alphas_prev = make_ddim_sampling_parameters(
        diffusion.alphas_cumprod.astype(np.float64), ddim_ts, eta=0.0
    )
    rev = np.arange(num_steps)[::-1]
    a_t = np.asarray(alphas, np.float64)[rev]         # current, loop order
    a_tgt = np.asarray(alphas_prev, np.float64)[rev]  # target of each step
    alpha_s, sigma_s = np.sqrt(a_t), np.sqrt(1.0 - a_t)
    alpha_t, sigma_t = np.sqrt(a_tgt), np.sqrt(1.0 - a_tgt)
    h = np.log(alpha_t / sigma_t) - np.log(alpha_s / sigma_s)  # > 0
    r = np.ones(num_steps)
    r[1:] = h[:-1] / h[1:]
    return DPMSchedule(
        ts=ddim_ts[rev].astype(np.int32),
        alpha_s=alpha_s.astype(np.float32),
        sigma_s=sigma_s.astype(np.float32),
        sig_ratio=(sigma_t / sigma_s).astype(np.float32),
        amul=(-alpha_t * np.expm1(-h)).astype(np.float32),
        r=r.astype(np.float32),
        gates=alpha_generator(num_steps, alpha_type).astype(np.float32),
    )


def dpm_sample(model_fn: ModelFn, sched: DPMSchedule, x_init: torch.Tensor,
               lower_order_final: bool | None = None) -> torch.Tensor:
    """x_T -> x_0 with DPM-Solver++(2M); returns the float32 latent."""
    s = sched.num_steps
    if lower_order_final is None:
        lower_order_final = s < 15
    x = x_init.float()
    b = x.shape[0]

    # the coefficients are float32 values; as Python floats they enter
    # float32 tensor arithmetic unchanged
    def x0_pred(x, i):
        t = torch.full((b,), int(sched.ts[i]), dtype=torch.long, device=x.device)
        eps = model_fn(x, t, float(sched.gates[i])).float()
        return (x - float(sched.sigma_s[i]) * eps) / float(sched.alpha_s[i])

    def update(x, i, x0, x0_prev):
        d = x0 if x0_prev is None else x0 + (x0 - x0_prev) / (2.0 * float(sched.r[i]))
        return float(sched.sig_ratio[i]) * x + float(sched.amul[i]) * d

    # step 0 peeled: no history, first order
    with span("step"):
        x0_prev = x0_pred(x, 0)
        x = update(x, 0, x0_prev, None)
    last = s - 1 if (lower_order_final and s > 1) else None
    stop = s if last is None else last
    for i in range(1, stop):
        with span("step"):
            x0 = x0_pred(x, i)
            x = update(x, i, x0, x0_prev)
        x0_prev = x0
    if last is not None:
        # first-order final step: the largest log-SNR jump lands here
        with span("step"):
            x = update(x, last, x0_pred(x, last), None)
    return x
