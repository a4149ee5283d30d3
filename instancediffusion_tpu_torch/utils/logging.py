"""Metrics, progress and observability (counterpart of
`instancediffusion_tpu/utils/logging.py`, copied; the profiler capture is
torch.profiler's).

Replaces the reference's meters + TensorBoard + wandb stack
(utils/misc.py:36-245, trainer.py:109-123, main_submitit.py:112-119):
console meters with ETA, an always-on scalars.jsonl, optional TensorBoard
scalars, optional wandb mirror, plus a torch.profiler trace capture."""

from __future__ import annotations

import time
from collections import deque


class AverageMeter:
    """Windowed average (utils/misc.py:172-190 semantics)."""

    def __init__(self, name: str, window: int = 100):
        self.name = name
        self.window = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.window.append(value)
        self.total += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def smoothed(self) -> float:
        return sum(self.window) / max(len(self.window), 1)


class MetricLogger:
    """Console + optional TensorBoard scalar logging with ETA."""

    def __init__(self, log_dir: str | None = None, total_iters: int | None = None):
        self.meters: dict[str, AverageMeter] = {}
        self.total_iters = total_iters
        self.t_start = time.time()
        self.writer = None
        self._jsonl = None
        if log_dir is not None:
            import os

            os.makedirs(log_dir, exist_ok=True)
            # always-on torch-free scalar log; TensorBoard is an optional
            # extra (torch.utils.tensorboard needs the tensorboard package)
            self._jsonl = open(
                os.path.join(log_dir, "scalars.jsonl"), "a", buffering=1
            )
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.writer = SummaryWriter(log_dir)
            except Exception:
                self.writer = None
        self.wandb = None

    def enable_wandb(self, project: str = "InstDiff", name: str | None = None,
                     config: dict | None = None):
        try:
            import wandb

            self.wandb = wandb.init(project=project, name=name, config=config)
        except Exception:
            self.wandb = None

    def log(self, step: int, values: dict[str, float]):
        for k, v in values.items():
            self.meters.setdefault(k, AverageMeter(k)).update(v)
            if self.writer is not None:
                self.writer.add_scalar(k, v, step)
            if self.wandb is not None:
                self.wandb.log({k: v}, step=step)
        if self._jsonl is not None:
            import json

            self._jsonl.write(
                json.dumps({"step": step, **values}) + "\n"
            )
        parts = [f"{k}: {m.smoothed:.4g}" for k, m in self.meters.items()]
        eta = ""
        if self.total_iters:
            rate = (time.time() - self.t_start) / max(step, 1)
            eta = f" eta {self._hms(rate * (self.total_iters - step))}"
        print(f"[iter {step}] " + "  ".join(parts) + eta, flush=True)

    def close(self) -> None:
        """Close scalars.jsonl and the TensorBoard writer."""
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
        if self.writer is not None:
            self.writer.close()
            self.writer = None

    @staticmethod
    def _hms(sec: float) -> str:
        sec = int(sec)
        return f"{sec // 3600}:{(sec % 3600) // 60:02d}:{sec % 60:02d}"


class ProfilerTrace:
    """torch.profiler capture of the host and, where there is one, the card:
    `with ProfilerTrace('/tmp/trace'): step()` writes a Chrome trace
    (trace.json, for Perfetto or chrome://tracing) into the directory."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.prof = None

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        import os

        self.prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
        return False
