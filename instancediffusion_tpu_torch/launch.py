"""Training launcher (counterpart of `instancediffusion_tpu/launch.py`; the
reference's run_with_submitit.py + main_submitit.py), on one GPU.

  * the training flags of main_submitit.py:15-82 with JAX's names and
    defaults, plus --device (default cuda; --device cpu runs on the CPU)
  * load_config(--yaml_file, flag overrides); the file needs PyYAML, and
    raises where it is not installed
  * a SIGTERM / SIGUSR1 handler: the Trainer finishes its step, saves
    checkpoint_latest and the process exits 0, so a requeued job
    auto-resumes from OUTPUT/name/tagXX
  * --multihost, --coordinator, --num_processes and --process_id raise:
    multi-GPU training is not ported yet (ROADMAP.md, Queue 1 item 5)
At the end it prints one line of timings ("trainer stats: {json}": data
wait and s/step, samples/s, save / restore / sample-grid seconds, peak
memory, kernel launches per step).

Usage:
  python -m instancediffusion_tpu_torch.launch --name run1 \\
      --train_list DATA/train.txt --official_ckpt DATA/v1-5-pruned-emaonly.ckpt
"""

from __future__ import annotations

import argparse
import json
import signal
import sys

MULTI_GPU_FLAGS = ("multihost", "coordinator", "num_processes", "process_id")


def get_args_parser():
    p = argparse.ArgumentParser("InstanceDiffusion PyTorch training launcher")
    # main_submitit.py flag names preserved
    p.add_argument("--name", type=str, default="test")
    p.add_argument("--yaml_file", type=str, default=None)
    p.add_argument("--train_list", type=str, required=True)
    p.add_argument("--official_ckpt", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=8)
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
    p.add_argument("--multihost", action="store_true",
                   help="multi-process training: not ported (raises)")
    p.add_argument("--coordinator", type=str, default=None, help="not ported (raises)")
    p.add_argument("--num_processes", type=int, default=None, help="not ported (raises)")
    p.add_argument("--process_id", type=int, default=None, help="not ported (raises)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, or cpu)")
    return p


def main(argv=None) -> int:
    args = get_args_parser().parse_args(argv)
    given = [f"--{k}" for k in MULTI_GPU_FLAGS if getattr(args, k) not in (None, False)]
    if given:
        raise NotImplementedError(
            f"{', '.join(given)}: multi-GPU training is not ported to the PyTorch package yet "
            "(ROADMAP.md, Queue 1 item 5); this launcher trains on one device")

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
                      device=args.device)

    # preemption -> finish the step, checkpoint, exit 0; the requeued job
    # auto-resumes
    def _preempt_handler(signum, frame):
        print(f"signal {signum}: checkpointing for requeue after this step...", flush=True)
        trainer.stop_signal = signum

    signal.signal(signal.SIGTERM, _preempt_handler)
    signal.signal(signal.SIGUSR1, _preempt_handler)

    trainer.start_training()
    print("trainer stats: " + json.dumps(trainer.stats()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
