"""The traced window of a benchmark cell, by the program's own spans.

    python3 tools/torch_span_breakdown.py --seed N [--aot DIR]

Runs the benchmark's one cell (`BENCHMARK.json`: its workload, for its
`run_seconds`) as `port_bench/run.py --trace 1` does, in this process (its
result line is printed as usual), keeps the traced window's profiler events
and reduces them by the spans the program opens (`idt.<name>`,
`instancediffusion_tpu_torch/utils/logging.span`) beside the benchmark's
own (`pb.<name>`):

- idle_gaps: every stretch with nothing on the card, by what the host was
  doing at its middle: the CUDA runtime call then in progress, else the
  innermost open span of either kind (`span:idt.step`, `span:attn`), else
  `host_python`. Spans are looked up by interval on each thread, so a span
  opened any number of events earlier still encloses the gap.
- device_s_by_span / idle_s_by_span / launches_by_span: device seconds of
  the kernels, copies and memsets launched under each innermost `idt.`
  span, the idle seconds whose middle falls under it, and the runtime calls
  that enqueue device work started under it.
- sample_idle_s: idle seconds whose middle falls while an `idt.sample` span
  (the request's program) is open, mean over the traced requests;
  sample_launches: runtime calls that enqueue device work started inside an
  `idt.sample` span, mean per request.
- span_us: host microseconds per `span` with no profiler session and inside
  one over the CPU and the card (measured before the run).

`--aot DIR` runs the program under the program cache (`enable_aot(DIR)`),
with the cell's request variant captured in set-up, so the window replays
CUDA graphs. Prints the reduction as one JSON line after `spans:` on
standard output. Needs a CUDA card; imports no JAX.

It reaches into the harness at two places (`trace.reduce`, whose events it
keeps, and `models.sd15_port`, for `--aot`), and its `reduce_spans` repeats
the device-work filter and the idle-gap walk of `trace.reduce`: it is to go,
with its tests in `tests/test_torch_spans.py`, once `trace.reduce` looks
spans up by interval and reads the program's `idt.` spans itself.
"""

from __future__ import annotations

import argparse
import bisect
import json
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SPAN_PREFIXES = ("idt.", "pb.")
# runtime calls that enqueue device work (kernels, graphs, copies, memsets)
ENQUEUE = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaLaunchCooperativeKernel"
                     r"|cudaGraphLaunch|cudaMemcpy\w*Async|cudaMemset\w*Async)")


class HostForest:
    """The host events of one thread (spans and runtime calls), which nest,
    with each one's parent: `innermost(t)` is the deepest event open at t."""

    def __init__(self, items: list[tuple[int, int, str]]):
        self.items = sorted(items, key=lambda it: (it[0], -it[1]))
        self.starts = [s for s, _, _ in self.items]
        self.parent: list[int] = []
        stack: list[int] = []
        for i, (s, _, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, t: int) -> int:
        """Index of the deepest event with start <= t <= end, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] < t:
            i = self.parent[i]
        return i

    def enclosing(self, i: int, prefix: str, name: str | None = None) -> int:
        """i or its nearest ancestor whose name starts with `prefix` (and is
        `name`, if given), or -1."""
        while i >= 0:
            n = self.items[i][2]
            if n.startswith(prefix) and (name is None or n == name):
                return i
            i = self.parent[i]
        return -1


def _label(name: str) -> str:
    """A span's name in the idle breakdown: the benchmark's without its
    prefix (`span:attn`, as the harness names it), the program's whole."""
    return "span:" + (name[3:] if name.startswith("pb.") else name)


def reduce_spans(events) -> dict:
    """The span breakdown of a traced window's profiler events (kineto
    events, or anything with their methods)."""
    import torch

    on_device, scopes, forests = [], set(), {}
    runtime = {}  # correlation id -> (thread, start)
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            on_device.append(e)
            continue
        name, tid = e.name(), e.start_thread_id()
        if not name.startswith("cu"):
            scopes.add(name)
        if name.startswith("cu"):
            runtime[e.correlation_id()] = (tid, e.start_ns())
        elif not name.startswith(SPAN_PREFIXES):
            continue
        forests.setdefault(tid, []).append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    forests = {tid: HostForest(items) for tid, items in forests.items()}
    # device work as the harness counts it: launched by a runtime call, not
    # the range a host scope draws on the device timeline
    device = [e for e in on_device if e.correlation_id() in runtime and e.name() not in scopes]

    def span_at(tid, t, prefix, name=None):
        f = forests[tid]
        i = f.enclosing(f.innermost(t), prefix, name)
        return None if i < 0 else (tid, i)

    device_by_span: dict[str, float] = {}
    for e in device:
        tid, t = runtime[e.correlation_id()]
        at = span_at(tid, t, "idt.")
        key = forests[tid].items[at[1]][2] if at else "outside"
        device_by_span[key] = device_by_span.get(key, 0.0) + e.duration_ns() / 1e9

    samples = {(tid, i) for tid, f in forests.items()
               for i, it in enumerate(f.items) if it[2] == "idt.sample"}
    launches = dict.fromkeys(samples, 0)
    launches_by_span: dict[str, int] = {}
    for tid, f in forests.items():
        for i, (_, _, name) in enumerate(f.items):
            if ENQUEUE.match(name):
                at = f.enclosing(i, "idt.")
                key = f.items[at][2] if at >= 0 else "outside"
                launches_by_span[key] = launches_by_span.get(key, 0) + 1
                at = f.enclosing(at, "idt.sample", "idt.sample")
                if at >= 0:
                    launches[(tid, at)] += 1

    merged: list[list[int]] = []
    for s, e in sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps: dict[str, float] = {}
    idle_by_span: dict[str, float] = {}
    sample_idle = dict.fromkeys(samples, 0.0)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid, sec = (a + b) // 2, (b - a) / 1e9
        call, deepest = None, None
        for tid, f in forests.items():
            i = f.innermost(mid)
            if i < 0:
                continue
            s, _, name = f.items[i]
            if not name.startswith(SPAN_PREFIXES):
                call = call or name
            else:
                deepest = max(deepest or (s, name), (s, name))
            at = span_at(tid, mid, "idt.")
            if at:
                key = f.items[at[1]][2]
                idle_by_span[key] = idle_by_span.get(key, 0.0) + sec
            at = span_at(tid, mid, "idt.sample", "idt.sample")
            if at:
                sample_idle[at] += sec
        what = call or (_label(deepest[1]) if deepest else "host_python")
        gaps[what] = gaps.get(what, 0.0) + sec

    n = len(samples)
    counts: dict[str, int] = {}
    for f in forests.values():
        for _, _, name in f.items:
            if name.startswith("idt."):
                counts[name] = counts.get(name, 0) + 1
    order = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))
    return {
        "idle_s": sum(gaps.values()),
        "idle_gaps": order(gaps),
        "device_s_by_span": order(device_by_span),
        "idle_s_by_span": order(idle_by_span),
        "launches_by_span": order(launches_by_span),
        "requests": n,
        "sample_idle_s": sum(sample_idle.values()) / n if n else None,
        "sample_launches": sum(launches.values()) / n if n else None,
        "span_counts": counts,
    }


def span_cost_us(n: int = 20000) -> dict:
    """Host microseconds per `with span(...)`: with no profiler session, and
    inside a torch.profiler session over the CPU and the card."""
    import torch

    from instancediffusion_tpu_torch.utils.logging import span

    def per_span() -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            with span("cost"):
                pass
        return (time.perf_counter() - t0) / n * 1e6

    off = per_span()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        on = per_span()
    return {"off": off, "on": on, "spans": n}


def replay_programs(aot_dir: str) -> None:
    """Make the harness build the port with the program cache on, and
    capture the cell's request variant (its steps, sampler, MIS step and
    instance count) before the window."""
    from port_bench.harness import layouts, models

    port = models.sd15_port

    def cached(config, traffic, weights, device, dtype):
        pipe = port(config, traffic, weights, device, dtype)
        pipe.enable_aot(aot_dir)
        seg = config["config"]["model"]["grounding_tokenizer"]["seg_resize_input"]
        meta = layouts.layout(layouts.rng(0, 3), traffic["instances"],
                              segs=traffic.get("segs", False), seg_size=seg)
        pipe.generate(meta, num_images=traffic["num_images"], steps=traffic["steps"],
                      sampler=traffic["sampler"], mis=traffic["mis"], seed=0)
        return pipe

    models.sd15_port = cached


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--aot", default=None, help="replay the program cache's graphs from DIR")
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (cell,) = bench["workloads"]
    sys.path.insert(0, str(ROOT))
    from port_bench import run as bench_run
    from port_bench.harness import trace

    if args.aot:
        replay_programs(args.aot)

    cost = span_cost_us()
    kept: dict = {}
    harness_reduce = trace.reduce

    def keep(events, window_s):
        events = list(events)
        kept.update(reduce_spans(events), window_s=window_s)
        return harness_reduce(events, window_s)

    trace.reduce = keep
    rc = bench_run.main(["--workload", cell["name"], "--seed", str(args.seed),
                         "--seconds", str(bench["run_seconds"]), "--trace", "1"])
    if rc != 0 or not kept:
        print(f"spans: the traced run gave no window (exit {rc})", file=sys.stderr)
        return rc or 1
    kept["span_us"] = cost
    print("spans: " + json.dumps(kept), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
