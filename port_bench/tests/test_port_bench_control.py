"""The control of every cell's output check on the card, at the cell's own
size: the reference at float8 put in the program's place reads above one
of the cell's limits on three seeds, while the program reads below all of
them. Marked
`cuda`; skips without a card. On the card:

    python -m pytest port_bench/tests/test_port_bench_control.py -q -p no:cacheprovider
"""

import json

import pytest
import torch

from port_bench import run as bench_run
from port_bench.harness.context import Run

BENCHMARK = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())
SEEDS = (101, 102, 103)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCHMARK["workloads"]])
def test_the_control_fails_and_the_program_passes(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = bench_run.cell_spec(BENCHMARK, workload)
    config = json.loads((bench_run.BENCH / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((bench_run.BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    driver = bench_run.load_module(bench_run.BENCH / "drivers" / f"{traffic['driver']}.py",
                                   "driver_" + traffic["driver"])
    for seed in SEEDS:
        ctx = Run(workload=workload, seed=seed, seconds=traffic.get("control_seconds", 0.0),
                  trace=False, device="cuda", config=config, traffic=dict(traffic, control=True))
        checks = driver.run(ctx).checks
        program = [c for c in checks if "." not in c.name]
        control = [c for c in checks if c.name.startswith("control.")]
        assert program and all(c.ok for c in program), checks
        assert control and not all(c.ok for c in control), checks  # it fails one number
        torch.cuda.empty_cache()
