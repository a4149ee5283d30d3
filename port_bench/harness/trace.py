"""The traced window: `torch.profiler` over the CPU and the card (the
benchmark's spans, the CUDA runtime calls and every kernel, copy and
memset; not each ATen op), reduced to the numbers the per-layer metrics
and the result line read.

- busy_s: seconds in which at least one kernel, copy or memset ran on the
  card (the union of their intervals); window_s: the traced window's
  length by the host clock.
- device_ops: device seconds by kernel name, the ten largest.
- idle_gaps: every stretch with nothing on the card, by what the host was
  doing at its middle (the CUDA runtime call then in progress, else the
  benchmark's innermost span, else "host_python"), the ten largest sums.
- span_device_s: for each span the benchmark opened with `span(name)`,
  the device seconds of the kernels launched while it was open.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import time

import torch

from port_bench.harness.stats import union_seconds

SPAN_PREFIX = "pb."


@contextlib.contextmanager
def span(name: str):
    """A benchmark span around a call into the port (a profiler range)."""
    with torch.profiler.record_function(SPAN_PREFIX + name):
        yield


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list
    span_device_s: dict


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:]+", "_", name)[:64]


def _user_scope_profile():
    """A started torch.profiler session over the CPU and the card that
    records the benchmark's spans (user scopes) and the CUDA runtime and
    device activity, but not every ATen op: recording each op cost the host
    as much as a third of a request. The profiler starts recording through
    `torch.autograd.profiler._enable_profiler`, which takes the scopes to
    record; the session is started with that call narrowed to user scopes."""
    import torch.autograd.profiler as ap
    from torch._C._profiler import RecordScope

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    enable = ap._enable_profiler
    ap._enable_profiler = lambda config, activities, scopes=None: enable(
        config, activities, {RecordScope.USER_SCOPE})
    try:
        prof.__enter__()
    finally:
        ap._enable_profiler = enable
    return prof


def prime() -> None:
    """Start and stop one short session, so that the profiler's one-time
    start-up (CUPTI's on the card) falls in set-up, not in the window."""
    prof = _user_scope_profile()
    with span("prime"):
        torch.ones(8, device="cuda" if torch.cuda.is_available() else "cpu").sum()
    prof.__exit__(None, None, None)


class Window:
    """`with Window(trace) as w:` around the measured work; with trace the
    profiler records it and `w.summary()` reduces it afterwards."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.prof = None
        self.window_s = 0.0

    def __enter__(self):
        if self.trace:
            self.prof = _user_scope_profile()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def summary(self) -> Summary:
        events = self.prof.profiler.kineto_results.events()
        return reduce(events, self.window_s)


def reduce(events, window_s: float) -> Summary:
    on_device, runtime, spans, scopes = [], [], [], set()
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            on_device.append(e)
        else:
            name = e.name()
            if not name.startswith("cu"):
                scopes.add(name)
            if name.startswith(SPAN_PREFIX):
                spans.append((e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns(),
                              name[len(SPAN_PREFIX):]))
            elif name.startswith("cu"):
                runtime.append(e)
    # device work is what a runtime call launched (kernels, copies, memsets);
    # the range the profiler draws on the device timeline for a host scope
    # (ours, or the optimizer's) is not work and would cover idle gaps
    launched = {r.correlation_id() for r in runtime}
    device = [e for e in on_device
              if e.correlation_id() in launched and e.name() not in scopes]
    intervals = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in device]
    busy = union_seconds(intervals)

    by_name: dict[str, float] = {}
    for e in device:
        key = _short(e.name())
        by_name[key] = by_name.get(key, 0.0) + e.duration_ns() / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # launches inside each span (same thread), then their kernels' time
    span_of_corr: dict[int, str] = {}
    by_thread: dict[int, list] = {}
    for tid, s, e, name in spans:
        by_thread.setdefault(tid, []).append((s, e, name))
    starts = {tid: [s for s, _, _ in sorted(v)] for tid, v in by_thread.items()}
    for tid in by_thread:
        by_thread[tid].sort()
    for r in runtime:
        lst = by_thread.get(r.start_thread_id())
        if not lst:
            continue
        t = r.start_ns()
        i = bisect.bisect_right(starts[r.start_thread_id()], t) - 1
        # spans of one thread nest: walk back to the innermost open one
        while i >= 0:
            s, e, name = lst[i]
            if s <= t <= e:
                span_of_corr[r.correlation_id()] = name
                break
            i -= 1
    span_device: dict[str, float] = {}
    for e in device:
        name = span_of_corr.get(e.correlation_id())
        if name is not None:
            span_device[name] = span_device.get(name, 0.0) + e.duration_ns() / 1e9

    gaps = _idle_gaps(intervals, runtime, spans)
    return Summary(busy_s=busy, window_s=window_s, device_ops=device_ops, idle_gaps=gaps,
                   span_device_s=span_device)


def _idle_gaps(intervals, runtime, spans) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    host = sorted([(r.start_ns(), r.start_ns() + r.duration_ns(), r.name()) for r in runtime]
                  + [(s, e, "span:" + n) for _, s, e, n in spans])
    host_starts = [h[0] for h in host]
    sums: dict[str, float] = {}
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        what = "host_python"
        i = bisect.bisect_right(host_starts, mid) - 1
        best = None
        # the runtime call covering the middle wins over an open span
        for j in range(i, max(-1, i - 64), -1):
            s, e, name = host[j]
            if s <= mid <= e:
                if not name.startswith("span:"):
                    best = name
                    break
                best = best or name
        if best is not None:
            what = best
        sums[what] = sums.get(what, 0.0) + (b - a) / 1e9
    return sorted(sums.items(), key=lambda kv: -kv[1])[:10]
