"""Build `csrc/*.cu` with nvcc into one shared library and bind it by ctypes.

Nothing is built at import. The first kernel call compiles every source of
`instancediffusion_tpu_torch/csrc/` for sm_90a into
`build/instancediffusion_tpu_torch/<hash of the sources>/` at the root of
the checkout and loads it; later calls (and later processes, while the
sources are unchanged) reuse that library. A missing nvcc or a failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR.parent / "build" / "instancediffusion_tpu_torch"
LIB_NAME = "libidt_kernels.so"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_LIB: ctypes.CDLL | None = None
BUILD_INFO: dict = {}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "idt_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _F, _P],
    "idt_group_norm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                       _I, _P],
    "idt_layer_norm": [_P, _P, _P, _P, _LL, _I, _F, _I, _P],
    "idt_geglu_ff": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(
            f"nvcc not found (PATH or {cuda_home}/bin): the port's CUDA "
            "kernels cannot be built"
        )
    return nvcc


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, cached=True)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in sorted(CSRC_DIR.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp, *cu],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}"
        )
    os.replace(tmp, lib)  # atomic: a process building at the same time sees all or nothing
    BUILD_INFO.update(path=str(lib), seconds=seconds, cached=False,
                      log=proc.stderr)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.idt_error_string.argtypes = [ctypes.c_int]
        handle.idt_error_string.restype = ctypes.c_char_p
        _LIB = handle
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = lib().idt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor,
                      dtypes=(torch.bfloat16,)) -> None:
    """The kernels take bf16 tensors (LayerNorm also fp32) on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: kernel takes {dtypes}, got {t.dtype}")
