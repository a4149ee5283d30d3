"""Data-parallel training with ZeRO-1 (counterpart of
`instancediffusion_tpu/parallel/zero.py`).

Parameters stay replicated on every rank of the "data" group. The AdamW
moments and the EMA (about 4.4 GB of fp32 state for the 369 M trainable
parameters at SD1.5 scale) are sharded: each rank keeps 1/N of them (ZeRO
stage 1, Rajbhandari et al. 2019). The layout is one flat fp32 buffer over
the trainable parameters in their module order, padded to a multiple of N;
rank r owns the contiguous slice [r, r + 1) * padded / N (`FlatLayout`).
Under ZeRO-1 the trainable parameters themselves become views of such a
buffer, so this rank's slice of them is the AdamW's one parameter and the
all_gather lands in the parameters: no copy of them is kept.

A step issues two collectives, the JAX program's psum and its update
all_gather:
  1. `all_reduce`: ONE all_reduce of the flat buffer holding every trainable
     gradient (zero where a parameter got none on this rank) and the rank's
     loss, divided by N: the averaged gradients and the global loss, on
     which every rank takes the same NaN-skip decision.
  2. `step`, with zero1: AdamW (`torch.optim.AdamW` over this rank's slice,
     the same arithmetic as the replicated optimizer) and the EMA on the
     slice, then ONE all_gather of the updated slices into the parameters.
     Without zero1 each rank runs the whole optimizer and EMA on the
     averaged gradients, and the step has no second collective.
No reduce_scatter: gloo does not offer it for CUDA tensors, and the design
needs only the two collectives above. The gradients are not bucketed into
the backward (DDP's hooks): overlapping the all_reduce with the backward is
left to later work.

Checkpoints keep the one-rank format: `full_state` gathers the moments and
the EMA into per-parameter tensors, `load_full_state` takes this rank's
slice of them again, so a checkpoint moves between rank counts.
"""

from __future__ import annotations

import torch

from instancediffusion_tpu_torch import parallel


class FlatLayout:
    """The flat buffer over `sizes` parameters and one loss slot, padded to
    a multiple of `world`; rank r owns [lo, hi) of it."""

    def __init__(self, sizes: list[int], world: int, rank: int):
        self.sizes = list(sizes)
        self.numel = sum(self.sizes)
        self.loss_at = self.numel
        self.world, self.rank = world, rank
        self.padded = -(-(self.numel + 1) // world) * world
        self.shard = self.padded // world
        self.lo, self.hi = rank * self.shard, (rank + 1) * self.shard

    def split(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """The per-parameter pieces (1-D views) of a flat buffer."""
        return list(flat[:self.numel].split(self.sizes))

    def sharded_bytes(self) -> int:
        """Bytes of this rank's AdamW moments and EMA (three fp32 slices)."""
        return 3 * 4 * self.shard


class DataParallel:
    """The gradient all_reduce and, with `zero1`, the sharded AdamW / EMA of
    the trainable parameters `params` ({name: parameter}, fp32) over the
    process group `group` (the default group when None)."""

    def __init__(self, params: dict, group=None, zero1: bool = True):
        import torch.distributed as dist

        self.group = group
        self.names = list(params)
        self.params = list(params.values())
        self.zero1 = zero1
        self.layout = FlatLayout([p.numel() for p in self.params],
                                 dist.get_world_size(group), dist.get_rank(group))
        lay = self.layout
        dev = self.params[0].device
        self.flat = torch.zeros(lay.padded, dtype=torch.float32, device=dev)
        self.param_flat = self.master = self.ema = None
        if zero1:
            with torch.no_grad():
                self.param_flat = torch.zeros(lay.padded, dtype=torch.float32, device=dev)
                for p, view in zip(self.params, lay.split(self.param_flat)):
                    view.copy_(p.detach().reshape(-1))
                    p.data = view.view_as(p)
                # this rank's slice of the parameters: the one parameter of its AdamW
                self.master = torch.nn.Parameter(self.param_flat[lay.lo:lay.hi])
                self.ema = self.master.detach().clone()

    def optimizer_params(self) -> list:
        """What the AdamW steps: this rank's slice, or every parameter."""
        return [self.master] if self.zero1 else self.params

    @torch.no_grad()
    def all_reduce(self, loss: torch.Tensor) -> torch.Tensor:
        """The one all_reduce of a step: every rank's gradients and loss,
        averaged. Returns the global mean loss (fp32, on the device). The
        parameters' own gradients are dropped once copied: the flat buffer
        holds them from here on."""
        lay = self.layout
        for dst, p in zip(lay.split(self.flat), self.params):
            if p.grad is None:
                dst.zero_()
            else:
                dst.copy_(p.grad.reshape(-1))
                p.grad = None
        self.flat[lay.loss_at] = loss.detach().float()
        self.flat[lay.loss_at + 1:].zero_()
        parallel.all_reduce(self.flat, group=self.group)
        self.flat.div_(lay.world)
        global_loss = self.flat[lay.loss_at].clone()
        self.flat[lay.loss_at] = 0.0
        return global_loss

    def load_grads(self) -> None:
        """Hand the averaged gradients to the optimizer: the slice's (views
        of the flat buffer) or each parameter's."""
        if self.zero1:
            self.master.grad = self.flat[self.layout.lo:self.layout.hi]
        else:
            for p, g in zip(self.params, self.layout.split(self.flat)):
                p.grad = g.view_as(p)

    @torch.no_grad()
    def finish_step(self, ema_rate: float) -> None:
        """zero1, after the optimizer stepped the slice: the EMA of the
        slice, then the one all_gather of every rank's slice into the
        parameters (their flat buffer; this rank's part is its own input)."""
        self.ema.mul_(ema_rate).add_(self.master.detach(), alpha=1.0 - ema_rate)
        self.master.grad = None
        parallel.all_gather(list(self.param_flat.chunk(self.layout.world)),
                            self.master.detach(), group=self.group)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
        if self.master is not None:
            self.master.grad = None

    # -- checkpoints --------------------------------------------------------

    def _gather_cpu(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's slice `t`, in rank order, as one flat CPU tensor."""
        outs = [torch.empty_like(t) for _ in range(self.layout.world)]
        parallel.all_gather(outs, t, group=self.group)
        return torch.cat([o.cpu() for o in outs])

    @torch.no_grad()
    def full_state(self, optimizer) -> tuple[dict, dict]:
        """zero1: (the optimizer's state dict in the one-rank format, the EMA
        as {name: tensor}), gathered from every rank (a collective: every
        rank calls it)."""
        lay = self.layout
        sd = optimizer.state_dict()
        slot = sd["state"].get(0)
        shapes = [p.shape for p in self.params]
        per = lambda flat: [t.view(s).clone() for t, s in zip(lay.split(flat), shapes)]
        state = {}
        if slot is not None:
            m, v = (per(self._gather_cpu(slot[k])) for k in ("exp_avg", "exp_avg_sq"))
            state = {i: {"step": slot["step"].clone(), "exp_avg": m[i], "exp_avg_sq": v[i]}
                     for i in range(len(self.params))}
        group = dict(sd["param_groups"][0], params=list(range(len(self.params))))
        ema = dict(zip(self.names, per(self._gather_cpu(self.ema))))
        return {"state": state, "param_groups": [group]}, ema

    @torch.no_grad()
    def load_full_state(self, optimizer, opt_sd: dict, ema: dict) -> None:
        """zero1: this rank's slice of a one-rank-format optimizer state and
        EMA (the parameters, whose slice the AdamW steps, are restored
        apart). A parameter without optimizer state starts from zero
        moments."""
        lay = self.layout
        sl = slice(lay.lo, lay.hi)
        flat = torch.zeros(lay.padded, dtype=torch.float32)

        def slice_of(tensors):
            flat.zero_()
            for dst, t in zip(lay.split(flat), tensors):
                if t is not None:
                    dst.copy_(t.reshape(-1))
            return flat[sl].clone()

        states = [opt_sd["state"].get(i) for i in range(len(self.params))]
        steps = [s["step"] for s in states if s is not None]
        slot = {}
        if steps:
            slot = {0: {"step": steps[0].clone(),
                        "exp_avg": slice_of([s and s["exp_avg"] for s in states]),
                        "exp_avg_sq": slice_of([s and s["exp_avg_sq"] for s in states])}}
        group = dict(opt_sd["param_groups"][0], params=[0])
        optimizer.load_state_dict({"state": slot, "param_groups": [group]})
        self.ema.copy_(slice_of([ema[n] for n in self.names]))
