"""One run of one cell: what a driver is given and what it gives back, and
the result line.

A driver (`drivers/<name>.py`, named by the traffic file's "driver") has
`run(ctx: Run) -> Outcome`. It sets up the system under test, calls
`ctx.start_window()` just before the first timed item (the end of
set-up), measures for `ctx.seconds`, reads the peak memory, frees the
program, and then runs the output check against the plain reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

BANNED_TOP_LEVEL = ("jax", "jaxlib", "flax", "instancediffusion_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux: /proc/self/stat)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Check:
    """One number of the output check and its limit: the run is correct
    only if value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Run:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    setup_s: float | None = None

    def start_window(self) -> float:
        """Record set-up as over; returns time.perf_counter() at the window's
        start."""
        self.setup_s = process_age()
        return time.perf_counter()


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict                       # name -> value
    checks: list                           # [Check]
    readings: dict = dataclasses.field(default_factory=dict)  # for per-layer readers
    summary: object = None                 # trace.Summary of a traced run
    memory_peak_bytes: int = 0

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(c.ok for c in self.checks)


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in BANNED_TOP_LEVEL})


def result_line(outcome: Outcome, metrics: dict, device: dict, breakdown: dict | None) -> str:
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return json.dumps(line)
