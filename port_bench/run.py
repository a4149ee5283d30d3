"""Run one cell of the benchmark once on the card and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up in the root `BENCHMARK.json`; its configuration file
(`configs/<config>.json`), traffic file (`traffic/<traffic>.json`, which
names its driver in `drivers/`) and per-layer metrics (`metrics/<metric>.py`)
are found by name. `--trace 0` prints the cell's end-to-end metrics, `--trace
1` its per-layer metrics from a traced window. The last line of standard
output is one JSON object; the numbers the output check compared, each with
its limit, are the last lines of standard error and the line's last key.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
PROGRAM = "instancediffusion_tpu_torch"  # the system under test, at the checkout's root


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(benchmark: dict, workload: str) -> dict:
    for w in benchmark["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metrics_of(benchmark: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or its per-layer metrics: those whose
    `workloads` name it, or without `workloads`, those that move an
    end-to-end metric the cell reports."""
    e2e = [m for m in benchmark["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in benchmark["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def power_limit() -> str:
    """The card's power limit as `nvidia-smi` reads it (the peaks assume
    700 W), or "not read"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip() or "not read"


def set_cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build" / "port_bench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    if not (ROOT / PROGRAM / "__init__.py").is_file():
        print(f"run: no {PROGRAM} package beside port_bench/ in {ROOT}: the benchmark runs "
              "from the root of a checkout of the whole repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    set_cache_dirs()
    benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_spec(benchmark, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    from port_bench.harness.context import Run, banned_modules, result_line
    from port_bench.harness.flops import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

    config = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = load_module(BENCH / "drivers" / f"{traffic['driver']}.py",
                         f"port_bench_driver_{traffic['driver']}")
    ctx = Run(workload=args.workload, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device="cuda", config=config, traffic=traffic)
    outcome = driver.run(ctx)

    bad = banned_modules()
    if bad:
        print(f"run: the process loaded {bad}: the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 4

    wanted = metrics_of(benchmark, args.workload, ctx.trace)
    values = dict(outcome.end_to_end, setup_s=ctx.setup_s)
    metrics, breakdown = {}, None
    if ctx.trace:
        values = {}
        for m in wanted:
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py",
                                 "port_bench_metric_" + m["name"].replace(".", "_"))
            v = reader.read(outcome)
            if v is not None:
                values[m["name"]] = v
        s = outcome.summary
        breakdown = {"device_ops": [[n, v] for n, v in s.device_ops],
                     "idle_gaps": [[n, v] for n, v in s.idle_gaps]}
    for m in wanted:
        if m["name"] in values:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    if ctx.trace:
        device.update(busy_s=outcome.summary.busy_s, window_s=outcome.summary.window_s)
    print(f"card: {device['kind']}, power limit {power_limit()}; roofline peaks "
          f"{PEAK_BF16_FLOPS / 1e12:g} TFLOP/s bf16, {PEAK_HBM_BYTES / 1e12:g} TB/s",
          file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} = {c.value!r} (limit {c.limit!r}): "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(result_line(outcome, metrics, device, breakdown), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
