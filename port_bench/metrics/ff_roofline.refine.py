"""Every feed-forward call of the refiner's transformer blocks (where
`models/unet.py` calls `_apply_ff_geglu`: the fused GEGLU kernel at C=768,
the unfused route at C=1536) as a share of its roofline, %."""

from port_bench.harness.readers import roofline


def read(outcome):
    return roofline(outcome, "ff")
