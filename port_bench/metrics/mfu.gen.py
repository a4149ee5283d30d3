"""Model FLOPs of the traced window's completed work at the H100 bf16 peak, %, in
the gen cell."""

from port_bench.harness.readers import mfu as read  # noqa: F401
