"""Every attention call of the UNet (where `models/unet.py` calls
`multi_head_attention`: self, cross and fuser attention, labeled calls by
their kept pairs) as a share of its roofline, %."""

from port_bench.harness.readers import roofline


def read(outcome):
    return roofline(outcome, "attn")
