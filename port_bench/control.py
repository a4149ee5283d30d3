"""Readings of a cell's output check over many seeds, and of its control.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 ... [--control-seeds 1 2 3]
        [--seconds S]

For each seed, one short run of the cell in this process (set-up, `S`
seconds of its traffic at its own load, the check against the reference)
prints the program's readings; for a control seed it also prints the
control's: the reference itself at float8 (one step below the bf16 the
configurations are served in) in the program's place, compared with the
float32 reference as the program is. A cell's limit lies between the
largest program reading and the smallest control reading (PERF.md). The
benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from port_bench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=None,
                   help="default: the traffic's control_seconds, else one request")
    args = p.parse_args(argv)
    bench_run.set_cache_dirs()
    import torch

    from port_bench.harness.context import Run

    benchmark = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
    cell = bench_run.cell_spec(benchmark, args.workload)
    config = json.loads((bench_run.BENCH / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((bench_run.BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = bench_run.load_module(bench_run.BENCH / "drivers" / f"{traffic['driver']}.py",
                                   "port_bench_driver")
    readings = []
    for seed in args.seeds:
        ctrl = seed in args.control_seeds
        t = dict(traffic, control=ctrl)
        seconds = traffic.get("control_seconds", 0.0) if args.seconds is None else args.seconds
        ctx = Run(workload=args.workload, seed=seed, seconds=seconds, trace=False,
                  device="cuda", config=config, traffic=t)
        out = driver.run(ctx)
        row = {"seed": seed, **{c.name: c.value for c in out.checks}, "value": out.end_to_end,
               "attempted": out.attempted, "failed": out.failed}
        print(json.dumps(row), flush=True)
        readings.append(row)
        torch.cuda.empty_cache()
    names = sorted({k for r in readings for k in r if k not in ("seed", "value", "attempted",
                                                                  "failed")})
    summary = {k: [r[k] for r in readings if k in r] for k in names}
    print(json.dumps({"workload": args.workload, "device": torch.cuda.get_device_name(0),
                      "max": {k: max(v) for k, v in summary.items()},
                      "min": {k: min(v) for k, v in summary.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
