"""Host seconds of a request's preparation before its program: the
pipeline's own `last_timings` text_encode + grounding_prep, mean over the
traced requests."""

from port_bench.harness.readers import reading


def read(outcome):
    return reading(outcome, "host_prep_s")
