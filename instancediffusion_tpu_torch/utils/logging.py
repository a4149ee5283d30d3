"""Metrics, progress and observability (counterpart of
`instancediffusion_tpu/utils/logging.py`, copied; its trace capture is
replaced by `span`).

Replaces the reference's meters + TensorBoard + wandb stack
(utils/misc.py:36-245, trainer.py:109-123, main_submitit.py:112-119):
console meters with ETA, an always-on scalars.jsonl, optional TensorBoard
scalars, optional wandb mirror, plus the program's spans (`span`): ranges
named `idt.<name>` on a torch.profiler session's timeline, beside the CUDA
runtime calls and the device's kernels."""

from __future__ import annotations

import contextlib
import functools
import time
from collections import deque

import torch

SPAN_PREFIX = "idt."

# a span outside a recording profiler session: one shared no-op context
_OFF = contextlib.nullcontext()


def span(name: str, timings: dict | None = None):
    """`with span(name):` marks a phase of the program. Only while a
    torch.profiler session records this thread does it open
    `record_function("idt." + name)`; otherwise it returns a shared no-op
    context (a check of the profiler's thread-local state, under 1 us on a
    host core). With `timings`, it also stores the host seconds of the
    block under `name` by `time.perf_counter()`. It never
    synchronises the device or reads a tensor."""
    if timings is not None:
        return _TimedSpan(name, timings)
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(SPAN_PREFIX + name)


def spanned(name: str):
    """Decorator: every call of the function runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _TimedSpan:
    """`span` with timings: the host seconds of the block land in
    timings[name], also when it raises."""

    def __init__(self, name: str, timings: dict):
        self.name, self.timings = name, timings
        self._range = None

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self._range = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timings[self.name] = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


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
                import sys
                import types

                # TensorBoard's TensorFlow-free route (what its `notf` build
                # selects): without it, torch's writer imports TensorFlow
                # wherever it is installed, ~12 s of a launcher's start on
                # an idle host core, for the same event files
                sys.modules.setdefault("tensorboard.compat.notf",
                                       types.ModuleType("tensorboard.compat.notf"))
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
