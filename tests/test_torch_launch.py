"""The port's training launcher on the CPU: `python -m
instancediffusion_tpu_torch.launch --device cpu` on a tiny config is
stopped by SIGTERM (it saves checkpoint_latest and exits 0) and resumed
(the next run auto-resumes at the saved step); the multi-GPU flags and a
YAML config without PyYAML raise; the logger and the profiler trace write
their files.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from instancediffusion_tpu_torch import launch
from instancediffusion_tpu_torch.config import load_config
from instancediffusion_tpu_torch.utils.logging import MetricLogger, ProfilerTrace

import chip_smoke
from tests.test_torch_trainer import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    """The launcher's environment: one intra-op thread. Beside the suite's
    other workers, a tiny CPU step on every core's worth of spinning
    OpenMP threads took 4.3 s instead of 0.3 s, and the launcher missed its
    kill timer."""
    return dict(os.environ, IDTPU_ALLOW_HASH_TOKENIZER="1", PYTHONPATH=REPO,
                OMP_NUM_THREADS="1")


def _launch(args, env, cwd):
    """The launcher in a session of its own, so a kill timer can end its
    decode processes with it (`os.killpg`)."""
    return subprocess.Popen([sys.executable, "-m", "instancediffusion_tpu_torch.launch", *args],
                            cwd=cwd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def test_launcher_sigterm_saves_and_resumes(tmp_path):
    """--device cpu on a tiny config: SIGTERM during training makes the
    launcher save checkpoint_latest and exit 0; the next run auto-resumes
    at the saved step and trains to --total_iters."""
    config = tmp_path / "tiny.yaml"  # JSON is YAML
    config.write_text(json.dumps(dict(TINY, train={"ckpt_every_iters": 1000,
                                                   "n_sample_batches": 0, "workers": 2})))
    listing = chip_smoke.write_training_records(str(tmp_path / "recs"), n=4)
    env = _env()
    common = ["--device", "cpu", "--yaml_file", str(config), "--train_list", listing,
              "--batch_size", "2", "--output_dir", str(tmp_path / "OUT"), "--name", "run"]
    proc = _launch(common + ["--total_iters", "100000"], env, REPO)
    timer = threading.Timer(240, os.killpg, (proc.pid, signal.SIGKILL))
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("[iter 10]"):
                proc.send_signal(signal.SIGTERM)
        rc = proc.wait()
    finally:
        timer.cancel()
    out = "".join(lines)
    assert rc == 0, out[-3000:]
    m = re.search(r"signal 15: saved checkpoint_latest at step (\d+)", out)
    assert m, out[-3000:]
    saved = int(m.group(1))
    assert saved >= 10
    assert (tmp_path / "OUT" / "run" / "tag00" / "checkpoint_latest").exists()
    done = subprocess.run([sys.executable, "-m", "instancediffusion_tpu_torch.launch", *common,
                           "--total_iters", str(saved + 2)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-2000:]
    assert f"at step {saved}" in done.stdout and "auto-resumed from" in done.stdout
    stats = json.loads(done.stdout.split("trainer stats: ")[1].splitlines()[0])
    assert stats["steps"] == 2 and stats["final_step"] == saved + 2
    assert (tmp_path / "OUT" / "run" / "tag01" / "checkpoint_latest").exists()


def test_launcher_sigterm_to_its_process_group_saves(tmp_path):
    """SIGTERM to the launcher's whole process group, as a scheduler sends
    it to every process of a job, while the decode processes decode an
    epoch's first batch (two records a batch, four records: every other
    step starts an epoch) and the launcher waits for it: they leave the
    signal to the launcher, which takes its step, saves checkpoint_latest
    and exits 0."""
    config = tmp_path / "tiny.yaml"  # JSON is YAML
    config.write_text(json.dumps(dict(TINY, train={"ckpt_every_iters": 1000,
                                                   "n_sample_batches": 0, "workers": 2})))
    listing = chip_smoke.write_training_records(str(tmp_path / "recs"), n=4)
    proc = _launch(["--device", "cpu", "--yaml_file", str(config), "--train_list", listing,
                    "--batch_size", "2", "--output_dir", str(tmp_path / "OUT"), "--name", "run",
                    "--total_iters", "100000"], _env(), REPO)
    timer = threading.Timer(120, os.killpg, (proc.pid, signal.SIGKILL))
    timer.start()
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("[iter 10]"):
                # step 10 ends epoch 4: epoch 5's samples are being decoded
                time.sleep(0.15)
                os.killpg(proc.pid, signal.SIGTERM)
        rc = proc.wait()
    finally:
        timer.cancel()
    out = "".join(lines)
    assert rc == 0, out[-3000:]
    m = re.search(r"signal 15: saved checkpoint_latest at step (\d+)", out)
    assert m and int(m.group(1)) >= 10, out[-3000:]
    assert (tmp_path / "OUT" / "run" / "tag00" / "checkpoint_latest").exists()


@pytest.mark.parametrize("flag", [["--multihost"], ["--coordinator", "localhost:1234"],
                                  ["--num_processes", "2"], ["--process_id", "1"]])
def test_launcher_refuses_multi_gpu_flags(flag):
    """The multi-process flags raise, pointing at the queued multi-GPU work,
    instead of training one process."""
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        launch.main(["--train_list", "unused.txt", *flag])


def test_yaml_config_without_pyyaml_raises(tmp_path, monkeypatch):
    """A YAML config without PyYAML raises saying so."""
    path = tmp_path / "c.yaml"
    path.write_text("train:\n  batch_size: 3\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="PyYAML"):
        load_config(str(path))


def test_metric_logger_and_profiler_trace(tmp_path):
    """MetricLogger writes scalars.jsonl (and closes it); ProfilerTrace
    writes a Chrome trace of torch.profiler."""
    log = MetricLogger(log_dir=str(tmp_path / "Log"), total_iters=20)
    log.log(10, {"loss": 0.5, "sec/iter": 0.1})
    log.log(20, {"loss": 0.25, "sec/iter": 0.1})
    log.close()
    rows = [json.loads(l) for l in (tmp_path / "Log" / "scalars.jsonl").read_text().splitlines()]
    assert rows == [{"step": 10, "loss": 0.5, "sec/iter": 0.1},
                    {"step": 20, "loss": 0.25, "sec/iter": 0.1}]
    assert log.meters["loss"].avg == pytest.approx(0.375)
    with ProfilerTrace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
