"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel (built from `csrc/` on first use) or
raises. `LAUNCHES` counts kernel launches per wrapper, so a run can show
that its main path went through the kernels. `ROUTES` counts the calls a
shape-or-dtype switch sent away from a kernel to a library route
(`ff_geglu_unfused`), so a run can check both sides of the switch.
"""

from __future__ import annotations

import collections

import torch

LAUNCHES: collections.Counter = collections.Counter()
ROUTES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()
    ROUTES.clear()


def kernel_dtype(dtype, fp32_too: bool = False) -> bool:
    """The dtype rule of every route, as in the JAX package: bf16 goes to the
    kernels, any other dtype to the plain versions (`fp32_too`: LayerNorm's
    kernel also takes fp32 rows). Decided before the call, never by a failed
    launch."""
    return dtype == torch.bfloat16 or (fp32_too and dtype == torch.float32)
