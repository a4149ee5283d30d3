"""InstanceDiffusion on PyTorch and CUDA (NVIDIA H100): a port of the
`instancediffusion_tpu` JAX package, which stays the reference.

The port mirrors the JAX package's module paths and function names
(`nn/core.py`, `ops/attention.py`, `kernels/...`, `models/unet.py`,
`samplers/plms.py`, `pipeline.py`). Its Pallas kernels are hand-written
CUDA C++ for sm_90a under `csrc/`, built with nvcc on first use.
Importing the package imports no JAX.
"""

__version__ = "0.1.0"
