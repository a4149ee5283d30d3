"""The seeded traffic: the same seed gives the same inputs, and every seed
the same sizes."""

import numpy as np

from port_bench.drivers import generate
from port_bench.tests import tiny


def test_generate_layouts_repeat_with_the_seed():
    a = tiny.run("gen", "sd15_instancediffusion", "plms50_mis036_mask_b8", seed=2**31 + 5)
    b = tiny.run("gen", "sd15_instancediffusion", "plms50_mis036_mask_b8", seed=2**31 + 5)
    c = tiny.run("gen", "sd15_instancediffusion", "plms50_mis036_mask_b8", seed=2**31 + 6)
    for i in range(3):
        (ma, sa), (mb, sb), (mc, _) = (generate.request_layout(r, i) for r in (a, b, c))
        assert sa == sb and ma["prompt"] == mb["prompt"] and ma["locations"] == mb["locations"]
        assert all(np.array_equal(x, y) for x, y in zip(ma["segs"], mb["segs"]))
        assert ma["locations"] != mc["locations"]
        assert len(ma["phrases"]) == len(mc["phrases"]) == a.traffic["instances"]
