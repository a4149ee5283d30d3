"""Trainable-parameter selection, optimizer and EMA (counterpart of
`instancediffusion_tpu/train/optimizer.py`).

Only the new InstanceDiffusion parameters train: the gated self-attention
fusers, the UniFusion grounding tokenizer (`position_net`) and the ScaleU
gains, chosen by parameter name. Everything else is frozen SD1.5.

Optimizer: AdamW (betas 0.9 / 0.999, eps 1e-8, weight decay 0 by default)
over the trainable parameters only; frozen parameters are in no parameter
group (the counterpart of optax.multi_transform with set_to_zero), so they
get neither moments nor updates. The learning rate follows a warmup
schedule read, as optax reads it, at the update count before the update:
the first update under warmup runs at lr 0.

EMA: ema = ema * rate + p * (1 - rate) on the trainable subset only (frozen
parameters are equal in the model and its EMA).
"""

from __future__ import annotations

import math

import torch

TRAINABLE_MARKERS = ("fuser", "position_net", "scaleu")


def is_trainable(name: str) -> bool:
    return any(m in name for m in TRAINABLE_MARKERS)


def trainable_mask(module: torch.nn.Module) -> dict[str, bool]:
    """{parameter name: trains?}; sets requires_grad on exactly the
    trainable parameters and clears it on the others."""
    mask = {}
    for name, p in module.named_parameters():
        mask[name] = is_trainable(name)
        p.requires_grad_(mask[name])
    return mask


def trainable_parameters(module: torch.nn.Module) -> dict[str, torch.nn.Parameter]:
    return {n: p for n, p in module.named_parameters() if is_trainable(n)}


def count_trainable(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in trainable_parameters(module).values())


def warmup_factor(count: int, warmup_steps: int, scheduler_type: str = "constant",
                  total_steps: int = 500_000) -> float:
    """Learning-rate multiplier at update count `count`: linear from 0 over
    `warmup_steps`, then constant, or cosine decay to 0 at `total_steps`
    (optax.join_schedules of linear + constant, and
    optax.warmup_cosine_decay_schedule)."""
    if count < warmup_steps:
        return count / warmup_steps
    if scheduler_type == "constant":
        return 1.0
    if scheduler_type != "cosine":
        raise ValueError(scheduler_type)
    decay = max(total_steps - warmup_steps, 1)
    frac = min(count - warmup_steps, decay) / decay
    return 0.5 * (1.0 + math.cos(math.pi * frac))


def make_optimizer(module: torch.nn.Module, learning_rate: float = 5e-5,
                   weight_decay: float = 0.0, warmup_steps: int = 5000,
                   scheduler_type: str = "constant", total_steps: int = 500_000):
    """(AdamW over the trainable parameters of `module`, its LambdaLR
    schedule). Step the schedule after each optimizer step: at construction
    it sets lr = learning_rate * factor(0), so update k runs at factor(k)."""
    if scheduler_type not in ("constant", "cosine"):
        raise ValueError(scheduler_type)
    trainable_mask(module)
    params = list(trainable_parameters(module).values())
    opt = torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda count: warmup_factor(count, warmup_steps, scheduler_type, total_steps))
    return opt, sched


def init_ema(module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Copies of the trainable parameters (the EMA owns its buffers)."""
    return {n: p.detach().clone() for n, p in trainable_parameters(module).items()}


@torch.no_grad()
def update_ema(ema: dict[str, torch.Tensor], module: torch.nn.Module,
               rate: float = 0.9999) -> None:
    """ema = ema * rate + p * (1 - rate), in place, trainable subset only."""
    params = dict(module.named_parameters())
    for name, e in ema.items():
        e.mul_(rate).add_(params[name].to(e.dtype), alpha=1.0 - rate)


def ema_full_params(ema: dict[str, torch.Tensor],
                    module: torch.nn.Module) -> dict[str, torch.Tensor]:
    """Full EMA weights for sampling or export: trainable parameters from
    the EMA, frozen ones from the live module."""
    return {n: ema.get(n, p.detach()) for n, p in module.named_parameters()}
