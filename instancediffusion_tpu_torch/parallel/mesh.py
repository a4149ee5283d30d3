"""Process group, device mesh and the batch's placement on it (counterpart of
`instancediffusion_tpu/parallel/mesh.py` and of `launch.init_distributed`).

The JAX package runs one process per host and shards over that host's
chips inside one program. Here it is **one process per GPU** (a rank), as the
reference's DDP runs it: the launcher's `--num_processes` counts ranks, not
hosts, and `--batch_size` is each rank's batch. The mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks with the JAX
package's axis names, ("data", "model"), ranks laid out as
`arange(world).reshape(n_data, n_model)` (JAX's device order): the ranks of
one "model" group are consecutive.

  * training: the ranks form the "data" axis; each reads its shard of the
    records (the Prefetcher), gradients are averaged by one all_reduce
    (`zero.DataParallel`), the parameters start equal (`replicate_params`)
  * sampling: the batch over "data" (`row_slice` gives a rank its rows,
    `gather_rows` returns every rank the whole batch), the transformer
    stack over "model" (`tp.py`)

Backends: NCCL for ranks on GPUs of their own, gloo on the CPU, and gloo
for ranks that share one GPU: NCCL refuses two ranks on one device, and
`init_distributed` raises before it would try.
"""

from __future__ import annotations

import datetime
import os
import socket

import torch
import torch.distributed as dist

from instancediffusion_tpu_torch import parallel

BACKENDS = ("nccl", "gloo")
AXES = ("data", "model")


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_and_world() -> tuple[int, int]:
    """(rank, world size) of the default group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str = "nccl", device=None,
                     timeout_s: float = 1800.0) -> tuple[int, int]:
    """Join the default process group and return (rank, world size), as
    JAX's `init_distributed` returns (process_index, process_count).

    With `coordinator` ("host:port" of rank 0), `num_processes` ranks and
    this one's `process_id`: a TCP rendezvous there. Without: `env://`
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, as torchrun sets them).
    `device` (a CUDA device) becomes this process's current device before
    any collective. NCCL without a card, or with two ranks on one device,
    raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("dist backend nccl needs a CUDA device and torch.cuda.is_available() "
                           "is false (use --dist_backend gloo on the CPU)")
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"--process_id {process_id} outside [0, {num_processes})")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    rank, world = dist.get_rank(), dist.get_world_size()
    if backend == "nccl" and world > 1:
        _refuse_shared_devices(rank)
    return rank, world


def _refuse_shared_devices(rank: int) -> None:
    """NCCL cannot run two ranks on one device: compare every rank's (host,
    device UUID) over a gloo group before NCCL's first collective."""
    dev = torch.cuda.current_device()
    me = (socket.gethostname(), str(torch.cuda.get_device_properties(dev).uuid))
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, me, group=dist.new_group(backend="gloo"))
    owners: dict = {}
    for r, key in enumerate(seen):
        owners.setdefault(key, []).append(r)
    shared = [rs for rs in owners.values() if len(rs) > 1]
    if shared:
        dist.destroy_process_group()
        raise RuntimeError(f"rank {rank}: ranks {shared[0]} share one GPU; NCCL refuses two ranks "
                           "on one device: run them with --dist_backend gloo")


def rank_device(device: str | None, rank: int, world: int) -> torch.device:
    """A rank's device: `device` when the caller gave one (every rank may
    then share it), else cuda:LOCAL_RANK (torchrun's; the rank itself
    without it). A rank with no GPU of its own raises."""
    if device is not None:
        return torch.device(device)
    if world == 1:
        return torch.device("cuda")
    local = int(os.environ.get("LOCAL_RANK", rank))
    count = torch.cuda.device_count()
    if local >= count:
        raise RuntimeError(f"rank {rank}: no cuda:{local} on this host ({count} CUDA devices); "
                           "pass --device to place the ranks yourself (cuda:0 puts every "
                           "rank on one card, with --dist_backend gloo)")
    return torch.device("cuda", local)


def make_mesh(n_data: int | None = None, n_model: int = 1, device_type: str | None = None):
    """The (n_data, n_model) DeviceMesh over the default group's ranks, axis
    names ("data", "model"); n_data defaults to world / n_model. Needs
    `init_distributed` first."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group (call init_distributed first)")
    world = dist.get_world_size()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} does not cover {world} ranks")
    # the mesh's groups take the default group's backend; gloo serves CUDA
    # tensors as well, so a gloo mesh is a "cpu" one whatever its ranks' devices
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh, axis: str) -> int:
    return 0 if mesh is None else mesh.get_local_rank(axis)


def row_slice(mesh, n: int) -> slice:
    """This rank's rows of an n-row batch over "data" (n a multiple of the
    axis size)."""
    d = axis_size(mesh, "data")
    if n % d:
        raise ValueError(f"{n} rows do not split over {d} data ranks")
    i = axis_index(mesh, "data")
    return slice(i * n // d, (i + 1) * n // d)


@torch.no_grad()
def replicate_params(params) -> None:
    """Broadcast each tensor of `params` from rank 0 to every rank of the
    default group, in place."""
    for p in params:
        parallel.broadcast(p.data, src=0)


def gather_rows(mesh, x: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """Every data rank's rows of `x` (equal shapes), in rank order, trimmed
    to the first `n`; the same on every rank."""
    d = axis_size(mesh, "data")
    if d == 1:
        return x if n is None else x[:n]
    outs = [torch.empty_like(x) for _ in range(d)]
    parallel.all_gather(outs, x, group=mesh.get_group("data"))
    out = torch.cat(outs)
    return out if n is None else out[:n]
