"""Model FLOPs of the traced window's refines (`harness/refiner_flops.py`:
the refiner UNet at its widths, OpenCLIP-bigG over two sequences, the VAE
encoder and decoder at the images' size) at the H100 bf16 peak, %, in the
refine cell."""

from port_bench.harness.readers import mfu as read  # noqa: F401
