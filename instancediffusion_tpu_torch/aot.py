"""Program cache of the port (counterpart of `instancediffusion_tpu/aot.py`).

In JAX a sampling variant is one compiled XLA program that the device runs
without the host, and the AOT cache keeps that program on disk across
restarts. The port runs eagerly, so its counterpart has two halves:

  * **one CUDA graph per variant.** `wrap(key, fn)` resolves a variant on
    its first call by the static key and the argument signature (shapes and
    dtypes); on a CUDA pipeline that call runs `fn` once on a side stream
    (cuDNN, cuBLAS and the kernels' plans warm up), then captures it under
    `torch.cuda.graph` into static input and output buffers. Later calls
    copy their inputs into those buffers and replay. Every variant of every
    cache in the process shares one memory pool; replays are serial on the
    caller's stream. The images
    a call returns are the graph's static output, which the next replay of
    that variant overwrites. A capture error runs that variant eagerly for
    the rest of the process, counted in `fallbacks` and logged. On a CPU
    pipeline there is no graph: the variant is resolved and `fn` runs.
  * **the kept kernel library.** A CUDA graph cannot outlive its process;
    what a restarted process would rebuild is the nvcc library of the
    hand-written kernels. `ensure_library` keeps it in the directory under a
    name keyed by the sources and NVCC_FLAGS, torch's version and its CUDA
    version, the card's compute capability and nvcc's version. A library
    found and loaded counts as `loads`; one built, or copied in from the one
    this process already loaded, and written atomically counts as `saves`;
    one that will not load (truncated, or a function missing) counts as
    `fallbacks` and is rebuilt from the sources and replaced. A kept file
    is first loaded in a throwaway process (`_build.probe`): a damaged
    shared object can kill the process that maps it. Without nvcc
    the newest library some nvcc built for the same sources, torch and card
    is taken; with none, the build raises. Nothing falls back to the plain
    PyTorch versions.

Each variant also gets a small JSON manifest, `<sampler>-<hash>.json`: its
key, its signature, the capture and instantiation seconds, the graph's node
count, the bytes its capture added to the pool and the kernel launches it
captured, so a restarted process can report
which variants a deployment used (it recaptures them; a graph is not loaded).

Usage (opt-in; nothing changes unless enabled):

    pipe.enable_aot("/var/cache/idt_programs")   # or serve(..., aot_dir=...)

Scope: single-process programs. `generate_batch(mesh=)` stays eager (gloo
collectives cannot be captured; JAX's cache skips mesh variants too).
Weights are read where they live when a graph replays, so a change made in
place (a LoRA merge: `io/lora.py` copies into the weights) reaches the
replays, and a weight replaced by a new tensor does not.
"""

from __future__ import annotations

import collections
import glob
import hashlib
import json
import logging
import os
import shutil
import tempfile
import time
import weakref
from pathlib import Path

import torch

from instancediffusion_tpu_torch import kernels
from instancediffusion_tpu_torch.kernels import _build

log = logging.getLogger(__name__)

LIB_PREFIX = "libidt_kernels-"
# the memory pool every live captured graph of the process shares (replays
# are serial on one stream, and each graph's outputs stay allocated), and the
# count of those graphs: once the last is freed the pool is released, and
# the next capture takes a new one (torch refuses to capture into a pool all
# of whose graphs are gone)
_POOL = None
_POOL_GRAPHS = 0


def _graph_freed(pool) -> None:
    global _POOL, _POOL_GRAPHS
    if pool == _POOL:
        _POOL_GRAPHS -= 1
        if _POOL_GRAPHS <= 0:
            _POOL, _POOL_GRAPHS = None, 0


def _flatten(args) -> tuple[list[torch.Tensor], str]:
    """(tensor leaves in order, signature): the signature names the nesting
    (dict keys sorted), each tensor's shape, dtype and device type, and any
    other leaf's value."""
    leaves: list[torch.Tensor] = []

    def walk(a) -> str:
        if isinstance(a, torch.Tensor):
            leaves.append(a)
            return f"{tuple(a.shape)}:{a.dtype}:{a.device.type}"
        if isinstance(a, dict):
            return "{" + ",".join(f"{k}={walk(a[k])}" for k in sorted(a)) + "}"
        if isinstance(a, (list, tuple)):
            return "[" + ",".join(walk(x) for x in a) + "]"
        return repr(a)

    return leaves, walk(list(args))


def _unflatten(args, leaves: list[torch.Tensor]):
    """`args` with its tensor leaves replaced by `leaves`, in `_flatten`'s
    order."""
    it = iter(leaves)

    def walk(a):
        if isinstance(a, torch.Tensor):
            return next(it)
        if isinstance(a, dict):
            return {k: walk(a[k]) for k in sorted(a)}
        if isinstance(a, (list, tuple)):
            return type(a)(walk(x) for x in a)
        return a

    return walk(args)


def _write_atomic(directory: Path, path: Path, write) -> None:
    """write(tmp_path) into a temporary file of `directory`, then rename it
    onto `path` (atomic: concurrent writers race safely)."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _graph_nodes(graph) -> int | None:
    """Node count of a captured graph kept as a cudaGraph_t
    (cudaGraphGetNodes through the CUDA runtime torch loaded), or None
    where the graph or the runtime call is not reachable."""
    import ctypes

    try:
        raw = graph.raw_cuda_graph()
        major = str(torch.version.cuda).split(".")[0]
        for name in (f"libcudart.so.{major}", "libcudart.so"):
            try:
                cudart = ctypes.CDLL(name)
                break
            except OSError:
                continue
        else:
            return None
        n = ctypes.c_size_t(0)
        err = cudart.cudaGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n))
        return int(n.value) if err == 0 else None
    except Exception:  # noqa: BLE001 - a count for the manifest, never a check
        return None


class _Variant:
    def __init__(self, name: str, key, signature: str):
        self.name, self.key, self.signature = name, key, signature
        self.graph = None
        self.static_in: list[torch.Tensor] = []
        self.static_out = None
        self.eager = False
        self.manifest: dict = {}


class AOTProgramCache:
    """A directory of kept kernel libraries and variant manifests, and the
    CUDA graphs of this process's variants; `wrap` turns a program into a
    callable that captures it once and replays it after. save=False writes
    nothing into the directory: a library missing there is built where a
    process without the cache builds it (`_build.lib`)."""

    def __init__(self, directory: str, save: bool = True):
        self.directory = Path(directory)
        self.save = save
        self.directory.mkdir(parents=True, exist_ok=True)
        # loads: a kept library found and loaded; saves: a library written;
        # fallbacks: a library that would not load (rebuilt) or a capture
        # that failed (that variant eager); captures / replays: CUDA graphs
        self.stats = {"loads": 0, "saves": 0, "fallbacks": 0, "captures": 0, "replays": 0}
        # name -> manifest of every variant this cache resolved
        self.variants: dict[str, dict] = {}
        self.errors: list[str] = []

    def _fallback(self, msg: str) -> None:
        self.stats["fallbacks"] += 1
        self.errors.append(msg)
        log.warning("aot: %s", msg)

    # -- the kept kernel library -------------------------------------------

    @staticmethod
    def library_base(capability: tuple[int, int]) -> str:
        """Hash of what a kept library is built from and for, nvcc aside:
        the sources and NVCC_FLAGS, torch's version and CUDA version, and
        the compute capability."""
        h = hashlib.sha256()
        for part in (_build.source_hash(), torch.__version__, str(torch.version.cuda),
                     "sm_%d%d" % tuple(capability)):
            h.update(part.encode() + b"\0")
        return h.hexdigest()[:16]

    def library_path(self, capability: tuple[int, int]) -> Path:
        """The kept library's file for this nvcc (`_build.nvcc_version`);
        raises without nvcc."""
        tag = hashlib.sha256(_build.nvcc_version().encode()).hexdigest()[:8]
        return self.directory / f"{LIB_PREFIX}{self.library_base(capability)}-{tag}.so"

    def _found_without_nvcc(self, capability) -> list[Path]:
        """Kept libraries for these sources, torch and card, newest first."""
        pattern = str(self.directory / f"{LIB_PREFIX}{self.library_base(capability)}-*.so")
        return sorted((Path(p) for p in glob.glob(pattern)),
                      key=lambda p: p.stat().st_mtime, reverse=True)

    def ensure_library(self, capability: tuple[int, int] | None = None) -> Path:
        """Load the kernel library from the directory, or build it there.
        Where this process has already loaded a library, a copy is saved for
        the next process (once). Returns the kept file."""
        if capability is None:
            capability = torch.cuda.get_device_capability()
        try:
            path = self.library_path(capability)
            candidates = [path] if path.exists() else []
        except RuntimeError:  # no nvcc: take what some nvcc built, or raise below
            path, candidates = None, self._found_without_nvcc(capability)
        if _build.loaded():
            if path is not None and self.save and not path.exists():
                _write_atomic(self.directory, path,
                              lambda tmp: shutil.copyfile(_build.LIB_PATH, tmp))
                self.stats["saves"] += 1
            return path if path is not None else _build.LIB_PATH
        for found in candidates:
            try:
                why = _build.probe(found)
                if why is not None:
                    raise OSError(why)
                handle = _build.bind(found)
            except (OSError, AttributeError) as e:
                self._fallback(f"library {found.name} does not load ({e}): rebuilt from the "
                               "sources")
                continue
            _build.install(handle, found)
            _build.BUILD_INFO.update(path=str(found), seconds=0.0, cached=True)
            self.stats["loads"] += 1
            return found
        if path is None:
            path = self.library_path(capability)  # raises: nothing to load, no nvcc
        if not self.save:  # build where a process without the cache builds
            _build.lib()
            return _build.LIB_PATH
        tmp_lib, seconds = _build.compile_library(self.directory)
        try:
            # bound at its temporary name: a replaced file of the same name
            # may still be mapped in this process
            handle = _build.bind(tmp_lib)
            os.replace(tmp_lib, path)
            self.stats["saves"] += 1
        finally:
            shutil.rmtree(tmp_lib.parent, ignore_errors=True)
        _build.install(handle, path)
        _build.BUILD_INFO.update(path=str(path), seconds=seconds, cached=False)
        return path

    # -- one CUDA graph per variant ----------------------------------------

    def _resolve(self, key, signature: str) -> _Variant:
        h = hashlib.sha256(repr(key).encode() + b"\0" + signature.encode()).hexdigest()[:20]
        sampler = dict(key).get("sampler", "program")
        v = _Variant(f"{sampler}-{h}", key, signature)
        v.manifest = {"name": v.name, "key": [[k, repr(x)] for k, x in key],
                      "signature": signature, "capture_s": None, "instantiate_s": None,
                      "nodes": None, "pool_bytes": None, "launches": None}
        self.variants[v.name] = v.manifest
        self._write_manifest(v)
        return v

    def _write_manifest(self, v: _Variant) -> None:
        if not self.save:
            return
        text = json.dumps(v.manifest, indent=1)
        _write_atomic(self.directory, self.directory / f"{v.name}.json",
                      lambda tmp: Path(tmp).write_text(text))

    def _capture(self, v: _Variant, fn, args, leaves: list[torch.Tensor]) -> None:
        dev = leaves[0].device
        v.static_in = [t.clone() for t in leaves]
        static_args = _unflatten(args, v.static_in)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*static_args)  # warm-up: handles, workspaces, kernel plans
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        global _POOL, _POOL_GRAPHS
        if _POOL is None:
            _POOL = torch.cuda.graph_pool_handle()
        pool = _POOL
        # torch.cuda.graph empties the cache on entry: do it first, so the
        # reserved bytes' growth is the pool's
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        before = collections.Counter(kernels.LAUNCHES)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)  # kept to count its nodes
        with torch.cuda.graph(graph, pool=pool):
            out = fn(*static_args)
        _POOL_GRAPHS += 1
        weakref.finalize(graph, _graph_freed, pool)
        capture_s = time.perf_counter() - t0
        nodes = _graph_nodes(graph)
        t0 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize(dev)
        v.manifest.update(
            capture_s=capture_s, instantiate_s=time.perf_counter() - t0, nodes=nodes,
            pool_bytes=torch.cuda.memory_reserved(dev) - reserved,
            launches={k: n - before[k] for k, n in kernels.LAUNCHES.items() if n != before[k]})
        v.graph, v.static_out = graph, out
        self.stats["captures"] += 1
        self._write_manifest(v)

    def wrap(self, key, fn):
        """`fn(*args)` as a cached program. key: ((name, value), ...) of every
        Python value `fn` freezes (its "sampler" names the variant). Each
        new argument signature under the key is a variant of its own."""
        variants: dict[str, _Variant] = {}

        def call(*args):
            leaves, signature = _flatten(args)
            v = variants.get(signature)
            if v is None:
                v = variants[signature] = self._resolve(key, signature)
            if not leaves or not leaves[0].is_cuda or v.eager:
                return fn(*args)
            if v.graph is None:
                try:
                    self._capture(v, fn, args, leaves)
                except Exception as e:  # noqa: BLE001 - any capture error
                    if _POOL_GRAPHS == 0:  # no graph holds the pool: a fresh one next
                        _graph_freed(_POOL)
                    torch.cuda.synchronize(leaves[0].device)
                    v.eager, v.graph, v.static_in = True, None, []
                    self._fallback(f"capture of {v.name} failed, eager from now on: "
                                   f"{type(e).__name__}: {e}")
                    return fn(*args)
            else:
                for dst, src in zip(v.static_in, leaves):
                    dst.copy_(src)
            v.graph.replay()
            self.stats["replays"] += 1
            return v.static_out

        return call
