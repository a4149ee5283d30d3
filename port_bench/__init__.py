"""The benchmark of the PyTorch and CUDA port (`instancediffusion_tpu_torch`).

`python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of the root `BENCHMARK.json` once on the
card and prints one JSON line. Everything a cell is made of is found by
name: its configuration in `configs/<config>.json`, its traffic mix in
`traffic/<traffic>.json` (which names the general driver in `drivers/`
that reads it), and each per-layer metric in `metrics/<metric>.py`. The
yardstick (traffic generation, the reduction of traces to metrics, the
peaks, the FLOP and byte counts, the plain reference in `reference/` and
the comparison that decides `correct`) lives here; of the port the
benchmark takes only the system under test.
"""
