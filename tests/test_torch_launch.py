"""The port's training launcher on the CPU: `python -m
instancediffusion_tpu_torch.launch --device cpu` on a tiny config is
stopped by SIGTERM (it saves checkpoint_latest and exits 0) and resumed
(the next run auto-resumes at the saved step); two ranks over gloo agree on
a stop one of them was sent and one process resumes their checkpoint; the
multi-rank flags parse into the rendezvous (and refuse an incomplete one),
nccl without a card and a YAML config without PyYAML raise; the logger and
the profiler trace write their files.
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
from instancediffusion_tpu_torch.utils.logging import MetricLogger

import chip_smoke
from tests import torch_ranks
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
    """Each multi-rank flag alone names no complete rendezvous (no torchrun
    environment, a coordinator without the ranks, ranks without a
    coordinator): it raises instead of training one process."""
    with pytest.raises(ValueError, match="--(multihost|coordinator|num_processes|process_id)"):
        launch.dist_args(launch.get_args_parser().parse_args(
            ["--train_list", "unused.txt", *flag]), environ={})
    with pytest.raises(ValueError):
        launch.main(["--train_list", "unused.txt", *flag])


@pytest.mark.parametrize("argv,environ,want", [
    (["--coordinator", "127.0.0.1:1234", "--num_processes", "2", "--process_id", "1"], {},
     dict(coordinator="127.0.0.1:1234", num_processes=2, process_id=1, backend="nccl")),
    (["--coordinator", "h:9", "--num_processes", "4", "--process_id", "0", "--device", "cpu"],
     {}, dict(coordinator="h:9", num_processes=4, process_id=0, backend="gloo")),
    (["--coordinator", "h:9", "--num_processes", "2", "--process_id", "1", "--device",
      "cuda:0", "--dist_backend", "gloo"], {},
     dict(coordinator="h:9", num_processes=2, process_id=1, backend="gloo")),
    (["--multihost"], {"WORLD_SIZE": "8"}, dict(backend="nccl")),
    ([], {"WORLD_SIZE": "2"}, dict(backend="nccl")),
    (["--device", "cpu"], {"WORLD_SIZE": "2"}, dict(backend="gloo")),
    ([], {}, None),
])
def test_launcher_dist_args(argv, environ, want):
    """The flags (and torchrun's environment) parse into `init_distributed`'s
    arguments: a TCP rendezvous at --coordinator, env:// under torchrun,
    none for one process; the backend nccl on CUDA and gloo on the CPU
    unless --dist_backend names it."""
    args = launch.get_args_parser().parse_args(["--train_list", "unused.txt", *argv])
    assert launch.dist_args(args, environ=environ) == want


def test_dist_backend_nccl_raises_without_a_card():
    """--dist_backend nccl on a host without a CUDA device raises before any
    rendezvous; it never falls back to gloo."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="nccl"):
        launch.main(["--train_list", "unused.txt", "--coordinator", "127.0.0.1:1",
                     "--num_processes", "1", "--process_id", "0", "--dist_backend", "nccl",
                     "--device", "cpu"])


def test_launcher_two_ranks_agree_on_a_stop_and_resume_on_one(tmp_path):
    """Two ranks on the CPU (--coordinator 127.0.0.1:PORT --num_processes 2
    --process_id R --device cpu, gloo, ZeRO-1): SIGTERM to rank 1 alone
    stops both after the same step; every step ran one all_reduce and one
    all_gather, both ranks logged the same global losses; rank 0 wrote
    checkpoint_latest, which one process resumes."""
    config = tmp_path / "tiny.yaml"
    config.write_text(json.dumps(dict(TINY, train={"ckpt_every_iters": 1000,
                                                   "n_sample_batches": 0, "workers": 1})))
    listing = chip_smoke.write_training_records(str(tmp_path / "recs"), n=4)
    env = _env()
    common = ["--device", "cpu", "--yaml_file", str(config), "--train_list", listing,
              "--batch_size", "1", "--output_dir", str(tmp_path / "OUT"), "--name", "run"]
    port = torch_ranks.free_port()
    procs = [_launch(common + ["--total_iters", "100000", "--coordinator", f"127.0.0.1:{port}",
                               "--num_processes", "2", "--process_id", str(r)], env, REPO)
             for r in range(2)]
    timers = [threading.Timer(240, os.killpg, (p.pid, signal.SIGKILL)) for p in procs]
    for t in timers:
        t.start()
    rank1: list = []
    drain = threading.Thread(target=lambda: rank1.extend(procs[1].stdout), daemon=True)
    drain.start()
    lines = []
    try:
        for line in procs[0].stdout:
            lines.append(line)
            if line.startswith("[iter 10]"):
                procs[1].send_signal(signal.SIGTERM)
        rcs = [p.wait() for p in procs]
        drain.join(30)
    finally:
        for t in timers:
            t.cancel()
    out, out1 = "".join(lines), "".join(rank1)
    assert rcs == [0, 0], out[-3000:] + out1[-3000:]
    m = re.search(r"signal 15: saved checkpoint_latest at step (\d+)", out)
    assert m and int(m.group(1)) >= 10, out[-3000:]
    saved = int(m.group(1))
    stats = [json.loads(o.split(head)[1].splitlines()[0])
             for o, head in ((out, "trainer stats: "), (out1, "rank 1 stats: "))]
    for st in stats:
        assert st["world_size"] == 2 and st["final_step"] == saved
        assert st["collective_calls_per_step"] == {"all_reduce": 1.0, "all_gather": 1.0}
    assert stats[0]["losses"] == stats[1]["losses"]
    assert (tmp_path / "OUT" / "run" / "tag00" / "checkpoint_latest").exists()
    assert not (tmp_path / "OUT" / "run" / "tag01").exists()
    done = subprocess.run([sys.executable, "-m", "instancediffusion_tpu_torch.launch", *common,
                           "--total_iters", str(saved + 2)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-2000:]
    assert f"at step {saved}" in done.stdout and "auto-resumed from" in done.stdout
    one = json.loads(done.stdout.split("trainer stats: ")[1].splitlines()[0])
    assert one["steps"] == 2 and one["final_step"] == saved + 2 and one["world_size"] == 1


def test_yaml_config_without_pyyaml_raises(tmp_path, monkeypatch):
    """A YAML config without PyYAML raises saying so."""
    path = tmp_path / "c.yaml"
    path.write_text("train:\n  batch_size: 3\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="PyYAML"):
        load_config(str(path))


def test_metric_logger(tmp_path):
    """MetricLogger writes scalars.jsonl (and closes it)."""
    log = MetricLogger(log_dir=str(tmp_path / "Log"), total_iters=20)
    log.log(10, {"loss": 0.5, "sec/iter": 0.1})
    log.log(20, {"loss": 0.25, "sec/iter": 0.1})
    log.close()
    rows = [json.loads(l) for l in (tmp_path / "Log" / "scalars.jsonl").read_text().splitlines()]
    assert rows == [{"step": 10, "loss": 0.5, "sec/iter": 0.1},
                    {"step": 20, "loss": 0.25, "sec/iter": 0.1}]
    assert log.meters["loss"].avg == pytest.approx(0.375)
