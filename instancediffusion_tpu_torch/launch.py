"""Training launcher (counterpart of `instancediffusion_tpu/launch.py`; the
reference's run_with_submitit.py + main_submitit.py), on one GPU or as one
rank of several.

  * the training flags of main_submitit.py:15-82 with JAX's names and
    defaults, plus --device and --dist_backend
  * load_config(--yaml_file, flag overrides); the file needs PyYAML, and
    raises where it is not installed
  * several ranks, one process per GPU (`parallel/mesh.py`): under torchrun
    (its environment, or --multihost) or with --coordinator HOST:PORT
    --num_processes N --process_id R on each rank. --num_processes counts
    ranks and --batch_size is each rank's batch. Each rank trains on
    cuda:LOCAL_RANK (the rank itself without torchrun) unless --device
    places it: --device cuda:0 puts every rank on one card, which needs
    --dist_backend gloo (NCCL refuses two ranks on one device, and the
    launcher raises before NCCL would), --device cpu runs on the CPU over
    gloo. --dist_backend defaults to nccl on CUDA and gloo on the CPU.
  * a SIGTERM / SIGUSR1 handler: the Trainer finishes its step, saves
    checkpoint_latest and the process exits 0, so a requeued job
    auto-resumes from OUTPUT/name/tagXX; over several ranks they agree on
    the stop after the same step
At the end rank 0 prints one line of timings ("trainer stats: {json}": data
wait and s/step, samples/s, save / restore / sample-grid seconds, peak
memory, kernel launches and collectives per step), every other rank one
"rank R stats: {json}" line.

Usage:
  python -m instancediffusion_tpu_torch.launch --name run1 \\
      --train_list DATA/train.txt --official_ckpt DATA/v1-5-pruned-emaonly.ckpt
  torchrun --nproc_per_node 8 -m instancediffusion_tpu_torch.launch --name run1 ...
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys


def get_args_parser():
    p = argparse.ArgumentParser("InstanceDiffusion PyTorch training launcher")
    # main_submitit.py flag names preserved
    p.add_argument("--name", type=str, default="test")
    p.add_argument("--yaml_file", type=str, default=None)
    p.add_argument("--train_list", type=str, required=True)
    p.add_argument("--official_ckpt", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=8, help="each rank's batch")
    p.add_argument("--base_learning_rate", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_steps", type=int, default=5000)
    p.add_argument("--scheduler_type", type=str, default="constant")
    p.add_argument("--total_iters", type=int, default=500000)
    p.add_argument("--save_every_iters", type=int, default=10000)
    p.add_argument("--ema_rate", type=float, default=0.9999)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--output_dir", type=str, default="OUTPUT")
    p.add_argument("--wandb", action="store_true")
    add_dist_args(p)
    p.add_argument("--device", type=str, default=None,
                   help="torch device of this rank (default cuda, cuda:LOCAL_RANK over "
                        "several ranks; cpu runs on the CPU)")
    return p


def add_dist_args(p: argparse.ArgumentParser) -> None:
    """The multi-rank flags (JAX's names; `dist_args` reads them)."""
    p.add_argument("--multihost", action="store_true",
                   help="join the ranks of torchrun's environment (implied by it)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of rank 0 for the TCP rendezvous")
    p.add_argument("--num_processes", type=int, default=None, help="ranks in all (with "
                   "--coordinator)")
    p.add_argument("--process_id", type=int, default=None, help="this rank (with --coordinator)")
    p.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="default nccl on CUDA, gloo on the CPU")


def dist_args(args, environ=None) -> dict | None:
    """`init_distributed`'s keyword arguments from the flags, or None for one
    process: --coordinator with --num_processes and --process_id (TCP), or
    --multihost / torchrun's WORLD_SIZE (env://). The backend is
    --dist_backend, else nccl for a CUDA device and gloo for the CPU."""
    from instancediffusion_tpu_torch.parallel.mesh import default_backend

    environ = os.environ if environ is None else environ
    given = [f for f in ("num_processes", "process_id") if getattr(args, f) is not None]
    if given and not args.coordinator:
        raise ValueError(f"--{given[0]} needs --coordinator (torchrun sets the ranks itself)")
    if args.coordinator and len(given) < 2:
        raise ValueError("--coordinator needs --num_processes and --process_id")
    if args.multihost and not args.coordinator and "WORLD_SIZE" not in environ:
        raise ValueError("--multihost: no torchrun environment (WORLD_SIZE) and no "
                         "--coordinator to meet the other ranks")
    if not (args.coordinator or args.multihost or "WORLD_SIZE" in environ):
        return None
    backend = args.dist_backend or default_backend(args.device or "cuda")
    if args.coordinator:
        return dict(coordinator=args.coordinator, num_processes=args.num_processes,
                    process_id=args.process_id, backend=backend)
    return dict(backend=backend)


def join(args) -> tuple[str | None, int, int]:
    """Join the process group the flags ask for: (this rank's device, rank,
    world size); the device stays as given for one process."""
    from instancediffusion_tpu_torch.parallel.mesh import init_distributed, rank_device

    kw = dist_args(args)
    if kw is None:
        return args.device, 0, 1
    rank = kw.get("process_id", int(os.environ.get("RANK", 0)))
    world = kw.get("num_processes") or int(os.environ.get("WORLD_SIZE", 1))
    device = rank_device(args.device, rank, world)
    rank, world = init_distributed(device=device, **kw)
    return str(device), rank, world


def main(argv=None) -> int:
    args = get_args_parser().parse_args(argv)
    device, rank, world = join(args)

    from instancediffusion_tpu_torch.config import load_config
    from instancediffusion_tpu_torch.train.trainer import Trainer

    overrides = {
        "train": {
            k: getattr(args, k)
            for k in (
                "name", "batch_size", "base_learning_rate", "weight_decay",
                "warmup_steps", "scheduler_type", "total_iters",
                "save_every_iters", "ema_rate", "seed", "output_dir", "wandb",
            )
        }
    }
    cfg = load_config(args.yaml_file, overrides)
    trainer = Trainer(cfg, args.train_list, pretrained_ckpt=args.official_ckpt,
                      device=device or "cuda")

    # preemption -> finish the step, checkpoint, exit 0; the requeued job
    # auto-resumes. The handler only sets the flag: CPython may run it
    # inside a print's flush, between two writes with stdout's lock held,
    # and a print of its own there raises "reentrant call inside
    # BufferedWriter" from the interrupted print (the Trainer says when it
    # stops)
    def _preempt_handler(signum, frame):
        trainer.stop_signal = signum

    signal.signal(signal.SIGTERM, _preempt_handler)
    signal.signal(signal.SIGUSR1, _preempt_handler)

    trainer.start_training()
    head = "trainer stats: " if rank == 0 else f"rank {rank} stats: "
    print(head + json.dumps(trainer.stats()), flush=True)
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
