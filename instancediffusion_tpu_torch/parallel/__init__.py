"""Multi-GPU execution of the port (counterpart of `instancediffusion_tpu/parallel/`):
the ("data", "model") device mesh and its collectives (`mesh.py`), ZeRO-1
data-parallel training (`zero.py`) and tensor parallelism of the UNet's
transformer stack (`tp.py`).

Every collective of these modules goes through the wrappers below, which
count calls and bytes in `COLLECTIVES` (`<name>` and `<name>_bytes`), so a
run can show how many collectives a step or a forward issued, as
`kernels.LAUNCHES` shows kernel launches. Gloo takes CUDA tensors for
`all_reduce`, `broadcast` and `all_gather` (a list of outputs); those are the
only tensor collectives used, so every path runs on NCCL and on gloo alike.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

COLLECTIVES: collections.Counter = collections.Counter()


def reset_collective_counts() -> None:
    COLLECTIVES.clear()


def _count(name: str, nbytes: int) -> None:
    COLLECTIVES[name] += 1
    COLLECTIVES[f"{name}_bytes"] += nbytes


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over `group`; returns `t`."""
    _count("all_reduce", t.numel() * t.element_size())
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(outs: list, t: torch.Tensor, group=None) -> list:
    """`t` of every rank of `group` into `outs`, in group-rank order (the
    bytes counted are those each rank receives)."""
    _count("all_gather", sum(o.numel() * o.element_size() for o in outs))
    dist.all_gather(outs, t.contiguous(), group=group)
    return outs


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """In place from global rank `src`."""
    _count("broadcast", t.numel() * t.element_size())
    dist.broadcast(t, src=src, group=group)
    return t
