"""Share of the traced window with no kernel on the card, %, in the gen cell."""

from port_bench.harness.readers import device_idle as read  # noqa: F401
