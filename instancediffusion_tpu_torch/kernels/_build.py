"""Build `csrc/*.cu` with nvcc into one shared library and bind it by ctypes.

Nothing is built at import. The first kernel call compiles every source of
`instancediffusion_tpu_torch/csrc/` for sm_90a, one nvcc process per source,
all started together, links the objects into one library in
`build/instancediffusion_tpu_torch/<hash of the sources>/` at the root of
the checkout and loads it; later calls (and later processes, while the
sources are unchanged) reuse that library. A missing nvcc or a failed build
raises: there is no fallback. Under `pipeline.enable_aot(directory)` the
library is kept in that directory instead (`aot.AOTProgramCache`), under a
name keyed by the sources, the flags, nvcc's version, torch's and its CUDA
version and the card's compute capability.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

_LIB: ctypes.CDLL | None = None
LIB_PATH: Path | None = None  # the file _LIB was loaded from
BUILD_INFO: dict = {}
_NVCC_VERSION: str | None = None

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "idt_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _F, _P],
    "idt_flash_tile_plan": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "idt_flash_bwd_dq": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _I, _F, _P],
    "idt_flash_bwd_dkv": [_P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _F, _P],
    "idt_group_norm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "idt_layer_norm": [_P, _P, _P, _P, _LL, _I, _F, _I, _I, _I, _P],
    "idt_geglu_ff": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "idt_proj_split": [_P, _LL, _LL, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "idt_merge_proj": [_P, _LL, _LL, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "idt_head_plan": [_I, _P, _P, _I, _P],
    "idt_head_max_clusters": [_I, _I, _I],
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


def nvcc_version() -> str:
    """The last line of `nvcc --version` (its build tag), read once a
    process; raises without nvcc."""
    global _NVCC_VERSION
    if _NVCC_VERSION is None:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                             check=True).stdout
        _NVCC_VERSION = out.strip().splitlines()[-1]
    return _NVCC_VERSION


def compile_library(out_dir: Path) -> tuple[Path, float]:
    """Compile every source with nvcc (one process each, all started
    together) and link them into a library in a fresh temporary directory
    under `out_dir`; writes `out_dir/build.log`. Returns (the library in
    its temporary directory, seconds): the caller moves it into place with
    os.replace and removes the directory. Raises on a failed build."""
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp_dir = Path(tempfile.mkdtemp(dir=out_dir))
    t0 = time.perf_counter()
    procs = []
    for cu in sorted(CSRC_DIR.glob("*.cu")):
        obj = tmp_dir / f"{cu.stem}.o"
        procs.append((cu.name, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-c", "-o", str(obj), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failed = [], []
    for name, _, proc in procs:
        out, err = proc.communicate()
        logs.append(f"== {name}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode}):\n{err[-8000:]}")
    tmp_lib = tmp_dir / LIB_NAME
    if not failed:
        objs = [str(obj) for _, obj, _ in procs]
        proc = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib), *objs],
                              capture_output=True, text=True)
        logs.append(f"== link\n{proc.stdout}{proc.stderr}")
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-8000:]}")
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    (out_dir / "build.log").write_text(log)
    if failed:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    BUILD_INFO.update(log=log)
    return tmp_lib, seconds


def build() -> Path:
    """Compile the kernels unless a library for these sources exists."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        BUILD_INFO.update(path=str(lib), seconds=0.0, cached=True)
        return lib
    tmp_lib, seconds = compile_library(out_dir)
    os.replace(tmp_lib, lib)  # atomic: a process building at the same time sees all or nothing
    shutil.rmtree(tmp_lib.parent, ignore_errors=True)
    BUILD_INFO.update(path=str(lib), seconds=seconds, cached=False)
    return lib


def probe(path) -> str | None:
    """Load the library at `path` in a throwaway process: None when it
    loads, else why not. A damaged shared object can kill the process that
    maps it (a truncated one raises SIGBUS inside dlopen), so a file of
    unknown health is tried there first."""
    import sys

    proc = subprocess.run([sys.executable, "-c", "import ctypes, sys; ctypes.CDLL(sys.argv[1])",
                           str(path)], capture_output=True, text=True, timeout=120)
    if proc.returncode == 0:
        return None
    return f"exit {proc.returncode}: {proc.stderr.strip()[-500:]}"


def bind(path) -> ctypes.CDLL:
    """Load the library at `path` and set the argument types of every
    exported function; raises OSError (not a loadable library) or
    AttributeError (a function missing)."""
    handle = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.idt_error_string.argtypes = [ctypes.c_int]
    handle.idt_error_string.restype = ctypes.c_char_p
    for name in ("idt_flash_encode_us", "idt_flash_bwd_encode_us"):
        getattr(handle, name).argtypes = []
        getattr(handle, name).restype = ctypes.c_double
    return handle


def install(handle: ctypes.CDLL, path) -> None:
    """Make `handle` (loaded from `path`) the library every wrapper calls."""
    global _LIB, LIB_PATH
    _LIB, LIB_PATH = handle, Path(path)


def loaded() -> bool:
    """Whether this process has loaded a kernel library."""
    return _LIB is not None


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    if _LIB is None:
        path = build()
        install(bind(path), path)
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
