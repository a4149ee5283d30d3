"""Tensor parallelism of the UNet's transformer stack over the mesh's "model"
axis (counterpart of `instancediffusion_tpu/parallel/tp.py`).

Megatron-style head and FF-column sharding (Shoeybi et al. 2019). Each rank
holds a copy of the UNet whose transformer blocks keep only its share
(`shard_unet`) and runs the ordinary forward at local shapes, the flash and
GEGLU kernels included, with two kinds of projection:

  column-parallel: to_q / to_k / to_v and the GEGLU up-projection keep 1/tp
    of their outputs: H/tp heads, 1/tp of the FF inner width. No
    communication.
  row-parallel: to_out and the GEGLU down-projection keep 1/tp of their
    inputs, so each rank's product is a partial sum; one all_reduce over
    "model" per projection (`models/unet._row_parallel`) completes it, and
    the replicated bias is added after the sum.

Layouts. The JAX package stores a linear weight as (in, out); torch's
`nn.Linear` stores (out, in). So JAX's column shard (`P(None, "model")`
on w) is a slice of **rows** (dim 0) of the torch weight, and JAX's row
shard (`P("model")` on w) a slice of **columns** (dim 1); a sharded bias is
a slice of dim 0 in both. `param_specs` gives each parameter its dim.

GEGLU interleave: the up-projection emits [a | gate], so a contiguous slice
of its rows would give rank 0 only `a` and the last rank only `gate`.
`shuffle_ffn_params` reorders the rows into per-rank [a_r | gate_r] blocks
so the local `chunk(2)` stays right; the down-projection's columns shard
contiguously.

Everything outside the transformer blocks (convs, res blocks, norms, time
embedding, ScaleU, UniFusion) stays replicated over "model". Per block
there are five row-parallel projections (three to_out and two FFs, the
fuser's and the block's; three at gate 0, where the fuser does not run):
`all_reduces_per_forward` counts them from the layer plan.
"""

from __future__ import annotations

import copy
import dataclasses
from contextlib import contextmanager

import torch

from instancediffusion_tpu_torch.parallel import mesh as mesh_mod

# ---------------------------------------------------------------------------
# The TP context: set around a forward; models/unet's row-parallel
# projections all_reduce over this group when it is set.
# ---------------------------------------------------------------------------

_GROUP: list = [None]


def group():
    """The "model" process group of the running forward, or None."""
    return _GROUP[-1]


@contextmanager
def tp_context(model_group):
    _GROUP.append(model_group)
    try:
        yield
    finally:
        _GROUP.pop()


# ---------------------------------------------------------------------------
# Parameter specs + the GEGLU row interleave
# ---------------------------------------------------------------------------

COLUMN_PARALLEL = ("to_q.weight", "to_k.weight", "to_v.weight", "ff.proj.weight",
                   "ff.proj.bias")
ROW_PARALLEL = ("to_out.weight", "ff.out.weight")


def param_specs(module: torch.nn.Module) -> dict:
    """{parameter name: the torch dim its "model" shard slices, or None
    (replicated)}: column-parallel weights and the GEGLU up bias dim 0,
    row-parallel weights dim 1; to_out / FF-down biases and everything
    outside the transformer blocks are replicated."""
    specs = {}
    for name, _ in module.named_parameters():
        if name.endswith(COLUMN_PARALLEL):
            specs[name] = 0
        elif name.endswith(ROW_PARALLEL):
            specs[name] = 1
        else:
            specs[name] = None
    return specs


def shuffle_ffn_params(t: torch.Tensor, tp_size: int) -> torch.Tensor:
    """A GEGLU up-projection weight (2*inner, C) or bias (2*inner,) with its
    rows reordered into per-rank [a_r | gate_r] blocks (only the sharded
    copy may be: the result is wrong for an unsharded forward). No-op at
    tp 1."""
    if tp_size == 1:
        return t
    inner = t.shape[0] // 2
    rest = t.shape[1:]
    return (t.reshape(2, tp_size, inner // tp_size, *rest).transpose(0, 1)
            .reshape(2 * inner, *rest))


def _shallow_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A module tree of new module objects sharing every parameter."""
    c = copy.copy(module)
    c._parameters = dict(module._parameters)
    c._buffers = dict(module._buffers)
    c._modules = {k: _shallow_copy(m) for k, m in module._modules.items()}
    return c


def shard_unet(unet: torch.nn.Module, mesh) -> torch.nn.Module:
    """This rank's copy of `unet` on the mesh's "model" axis: the transformer
    blocks' sharded parameters replaced by its slice (GEGLU interleaved
    first), every other parameter shared with `unet`. The heads must split
    evenly."""
    return shard_module(unet, mesh_mod.axis_size(mesh, "model"),
                        mesh_mod.axis_index(mesh, "model"))


@torch.no_grad()
def shard_module(unet: torch.nn.Module, tp_size: int, tp_rank: int) -> torch.nn.Module:
    """`shard_unet` for "model" rank `tp_rank` of `tp_size`."""
    heads = unet.cfg.num_heads
    if heads % tp_size:
        raise ValueError(f"num_heads={heads} does not split over tp={tp_size}")
    local = _shallow_copy(unet)
    if tp_size == 1:
        return local
    for name, dim in param_specs(unet).items():
        if dim is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = local.get_submodule(owner_name)
        t = owner._parameters[leaf]
        if name.endswith(("ff.proj.weight", "ff.proj.bias")):
            t = shuffle_ffn_params(t, tp_size)
        n = t.shape[dim]
        if n % tp_size:
            raise ValueError(f"{name}: {n} does not split over tp={tp_size}")
        part = t.narrow(dim, tp_rank * n // tp_size, n // tp_size).contiguous()
        owner._parameters[leaf] = torch.nn.Parameter(part, requires_grad=False)
    return local


def all_reduces_per_forward(cfg, gate_scale: float = 1.0) -> int:
    """Row-parallel projections of one forward, from the layer plan: per
    transformer block three to_out and two FFs (the fuser's attention and
    FF only when the gate is not 0)."""
    from instancediffusion_tpu_torch.models.unet import build_plan

    ins, mid, outs = build_plan(cfg)
    blocks = sum(s.kind == "attn" for blk in ins + [mid] + outs for s in blk)
    return blocks * cfg.transformer_depth * (5 if gate_scale != 0.0 else 3)


# ---------------------------------------------------------------------------
# The sharded forward
# ---------------------------------------------------------------------------


def tp_forward(mesh, local_unet, cfg, x, timesteps, context, *, gate_scale=1.0,
               precomputed_objs=None, fuser_mask=None):
    """`apply_unet` (same arguments) of this rank's rows under the "model"
    group, on the rank's sharded UNet (`shard_unet`) at H / tp heads."""
    from instancediffusion_tpu_torch.models import unet

    tp_size = mesh_mod.axis_size(mesh, "model")
    local_cfg = dataclasses.replace(cfg, num_heads=cfg.num_heads // tp_size)
    with tp_context(mesh.get_group("model") if tp_size > 1 else None):
        return unet.apply_unet(local_unet, local_cfg, x, timesteps, context,
                               gate_scale=gate_scale, precomputed_objs=precomputed_objs,
                               fuser_mask=fuser_mask)


def tp_apply_unet(mesh, cfg, local_unet, x, timesteps, context, objs, *, gate_scale=1.0,
                  fuser_mask=None):
    """apply_unet over a (data, model) mesh, as JAX's `tp_apply_unet`: the
    whole batch in (the same on every rank), its rows over "data", heads and
    FF width over "model", the whole batch out on every rank. `local_unet`
    is this rank's `shard_unet`; `objs` are the precomputed grounding tokens
    (UniFusion runs replicated outside the TP region)."""
    rows = mesh_mod.row_slice(mesh, x.shape[0])
    if fuser_mask is not None:  # (bits, open) labels or a dense mask
        fuser_mask = (tuple(a[rows] for a in fuser_mask) if isinstance(fuser_mask, tuple)
                      else fuser_mask[rows])
    out = tp_forward(mesh, local_unet, cfg, x[rows], timesteps[rows], context[rows],
                     gate_scale=gate_scale, precomputed_objs=objs[rows], fuser_mask=fuser_mask)
    return mesh_mod.gather_rows(mesh, out.contiguous(), x.shape[0])
