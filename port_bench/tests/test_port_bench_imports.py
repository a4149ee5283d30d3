"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port: checked in fresh interpreters, by
whole top-level module names."""

import json
import subprocess
import sys

from port_bench import run as bench_run

DRY_RUN = """
import json, sys, torch
torch.set_num_threads(2)
from port_bench.tests import tiny
from port_bench.drivers import generate
ctx = tiny.run("gen", "sd15_instancediffusion", "plms50_mis036_mask_b8", steps=5,
               num_images=1, instances=1, check_images=1, warmup_steps=4)
out = generate.run(ctx)
from port_bench.harness.context import banned_modules
print(json.dumps({"correct": out.correct, "banned": banned_modules(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""

REFERENCE_ONLY = """
import json, sys, torch
from port_bench.harness import models
from port_bench.tests import tiny
cfg, t = tiny.config("sd15_instancediffusion"), tiny.traffic("plms50_mis036_mask_b8")
w = models.sd15_weights(cfg, 3, "cpu", torch.float32)
ref = models.sd15_reference(cfg, t, w, "cpu")
meta = {"prompt": "a cat", "phrases": ["a cat"], "locations": [[0.1, 0.1, 0.6, 0.6]]}
img = ref.generate(meta, 1, 5, "plms", 0.36, 1, [0])
print(json.dumps({"shape": list(img.shape), "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def _run(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=bench_run.ROOT, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_dry_run_loads_no_jax():
    got = _run(DRY_RUN)
    assert got["correct"]
    assert got["banned"] == []
    assert not {"jax", "jaxlib", "flax", "instancediffusion_tpu"} & set(got["tops"])
    assert "instancediffusion_tpu_torch" in got["tops"]  # the system under test ran


def test_the_reference_loads_nothing_of_the_port():
    got = _run(REFERENCE_ONLY)
    assert got["shape"] == [1, 16, 16, 3]
    assert not {"instancediffusion_tpu_torch", "instancediffusion_tpu", "jax",
                "jaxlib"} & set(got["tops"])
