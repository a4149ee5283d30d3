"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each wrapper takes its plain version only for a tensor on the CPU; for a
CUDA tensor it launches the kernel (built from `csrc/` on first use) or
raises. `LAUNCHES` counts kernel launches per wrapper, so a run can show
that its main path went through the kernels.
"""

from __future__ import annotations

import collections

LAUNCHES: collections.Counter = collections.Counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()
