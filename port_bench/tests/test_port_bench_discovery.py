"""The harness finds everything of a cell by name: a new cell, traffic mix,
configuration or per-layer metric is files and BENCHMARK.json entries
alone."""

import json

from port_bench import run as bench_run

BENCHMARK = json.loads((bench_run.ROOT / "BENCHMARK.json").read_text())


def test_every_name_in_benchmark_json_has_its_files():
    for c in BENCHMARK["configs"]:
        assert (bench_run.ROOT / c["file"]).is_file()
        assert c["file"] == f"port_bench/configs/{c['name']}.json"
    for w in BENCHMARK["workloads"]:
        traffic = json.loads((bench_run.BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (bench_run.BENCH / "drivers" / f"{traffic['driver']}.py").is_file()
        driver = bench_run.load_module(bench_run.BENCH / "drivers" / f"{traffic['driver']}.py",
                                       "d_" + traffic["driver"])
        assert callable(driver.run)
        e2e = bench_run.metrics_of(BENCHMARK, w["name"], trace=False)
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert bench_run.metrics_of(BENCHMARK, w["name"], trace=True)
    for m in BENCHMARK["per_layer"]:
        reader = bench_run.load_module(bench_run.BENCH / "metrics" / f"{m['name']}.py", "m")
        assert callable(reader.read)


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    bench = json.loads(json.dumps(BENCHMARK))
    bench["workloads"].append({"name": "new_cell", "config": "sd15_instancediffusion",
                               "traffic": "new_mix", "chips": 1, "why": "x"})
    bench["end_to_end"][0].setdefault("workloads", []).append("new_cell")
    bench["per_layer"].append({"name": "new_metric.new", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "Device",
                               "moves": bench["end_to_end"][0]["name"]})
    assert bench_run.cell_spec(bench, "new_cell")["traffic"] == "new_mix"
    names = {m["name"] for m in bench_run.metrics_of(bench, "new_cell", trace=True)}
    assert "new_metric.new" in names
    # a metric without `workloads` reaches every cell that reports what it moves
    for w in BENCHMARK["workloads"]:
        moved = {m["name"] for m in bench_run.metrics_of(bench, w["name"], trace=False)}
        got = {m["name"] for m in bench_run.metrics_of(bench, w["name"], trace=True)}
        assert ("new_metric.new" in got) == (bench["end_to_end"][0]["name"] in moved)
    f = tmp_path / "new_metric.new.py"
    f.write_text("def read(outcome):\n    return 42.0\n")
    assert bench_run.load_module(f, "new_metric").read(None) == 42.0
