"""Multi-Instance Sampler (MIS): per-instance latent trajectories
(counterpart of `instancediffusion_tpu/samplers/mis.py`).

For the first `mis_step` steps each of the num_traj = k+1 conditionings
(trajectory 0 holds every instance, trajectory j+1 instance j alone) is
denoised from the SAME starting noise; the trajectories ride the batch
axis, trajectory-major (rows [j*B, (j+1)*B) are trajectory j), so the UNet
sees one forward of num_traj*B rows. The latents are then merged (a mean,
or a box crop-and-paste) and PLMS continues under the global conditioning,
reusing trajectory 0's eps history, so phase 2 has no order-1 step.
"""

from __future__ import annotations

from typing import Callable

import torch

from port_bench.reference.plms import PLMSSchedule, plms_steps

ModelFn = Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor]


def mis_sample(traj_model_fn: ModelFn, global_model_fn: ModelFn, sched: PLMSSchedule,
               x_init: torch.Tensor, num_traj: int, mis_step: int) -> torch.Tensor:
    """x_init (B,H,W,C) shared starting noise; traj_model_fn runs on the
    trajectory-stacked (num_traj*B, H, W, C) batch; the trajectories merge
    by their mean (the port's default). Returns the float32 latent."""
    s = sched.num_steps
    if mis_step == 0 or num_traj <= 1:
        return plms_steps(global_model_fn, sched, x_init, 0, s)[0]
    b = x_init.shape[0]
    # all trajectories start from the same noise
    x_stack = x_init.repeat(num_traj, 1, 1, 1)
    x_stack, hist = plms_steps(traj_model_fn, sched, x_stack, 0, mis_step)

    x = x_stack.reshape(num_traj, b, *x_init.shape[1:]).mean(dim=0)

    # phase 2: global conditioning, trajectory 0's history carried over
    hist0 = [e.reshape(num_traj, b, *e.shape[1:])[0] for e in hist]
    return plms_steps(global_model_fn, sched, x, mis_step, s, hist=hist0,
                      assume_history=True)[0]


def stack_groundings(groundings: list[dict]) -> dict:
    """Concatenate per-trajectory grounding dicts along the batch."""
    return {k: torch.cat([g[k] for g in groundings], dim=0) for k in groundings[0]}
