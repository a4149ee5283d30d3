"""Every attention call of the refiner UNet (where `models/unet.py` calls
`multi_head_attention`: the packed flash kernel at ds2, plain self-attention
at ds4 and ds8, cross-attention over 77 tokens) as a share of its roofline,
%."""

from port_bench.harness.readers import roofline


def read(outcome):
    return roofline(outcome, "attn")
