"""ctypes bindings for the port's native data library (counterpart of
`instancediffusion_tpu/data/_native.py`): `native/dataops.cpp` (COCO RLE,
box rasters, image normalisation; copied from the JAX package's
`native/`), `native/jpeg.cpp` (the JPEG decoder), `native/jpeg_encode.cpp`
(the JPEG encoder), `native/resample.cpp` (PIL's resize passes and
OpenCV's INTER_CUBIC),
`native/contours.cpp` (border following and interior polygon points) and
`native/fill_poly.cpp` (cv2.fillPoly).

Nothing is built at import. The first call compiles every
`instancediffusion_tpu_torch/native/*.cpp` with `g++ -O3 -shared -fPIC`
into `build/instancediffusion_tpu_torch/native/<hash of the sources>/` at
the root of the checkout (git-ignored), under a temporary name renamed into
place, so processes that build at once each see the whole library or
none. Unlike the JAX package's binding, which returns None and falls back
to numpy, a library that does not build raises: the loader then has no
decoder for JPEG records.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "native"
BUILD_ROOT = PKG_DIR.parent / "build" / "instancediffusion_tpu_torch" / "native"
LIB_NAME = "libidt_dataops.so"
# no fused multiply-adds: the native code rounds as numpy does
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]

_LIB: ctypes.CDLL | None = None

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "rle_decode": (_I, [ctypes.c_char_p, _I64, _I64, _I64, _P]),
    "rle_encode": (_I64, [_P, _I64, _I64, ctypes.c_char_p, _I64]),
    "normalize_image": (None, [_P, _I64, _P]),
    "idt_jpeg_info": (_I, [ctypes.c_char_p, _I64, _P, ctypes.c_char_p, _I]),
    "idt_jpeg_decode": (_I, [ctypes.c_char_p, _I64, _P, ctypes.c_char_p, _I]),
    "idt_jpeg_encode": (_I64, [_P, _I64, _I64, _P, _I64]),
    "idt_find_contours": (_I64, [_P, _I64, _I64, _P, _I64, _P, _I64]),
    "idt_uniform_sparse_points": (_I64, [_P, _I64, _I64, _I64, _P]),
    "idt_fill_poly": (None, [_P, _I64, _I64, _P, _P, _I64, _I64]),
    "idt_resample_h": (None, [_P, _I64, _I64, _I64, _P, _P, _I64, _I64, _P]),
    "idt_resample_v": (None, [_P, _I64, _P, _P, _I64, _I64, _P]),
    "idt_resize_cubic": (None, [_P, _I64, _I64, _I64, _P, _P, _I64, _P, _P, _I64, _P]),
}


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cpp"))


def source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless one for these sources exists; raise if
    g++ is missing or fails."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the port's native data library "
                           f"({SRC_DIR}) cannot be built")
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".build-", suffix=".so", dir=out_dir)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *map(str, _sources())],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building {LIB_NAME}:\n"
                               f"{proc.stderr[-8000:]}")
        os.replace(tmp, lib)  # atomic: a process building at once sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _LIB
    if _LIB is None:
        handle = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = handle
    return _LIB


def rle_decode_native(counts: bytes, h: int, w: int) -> np.ndarray | None:
    """(h, w) uint8 mask from compressed COCO RLE counts; None when the
    counts are malformed (the caller's numpy path then reports them)."""
    out = np.zeros((h, w), np.uint8)
    rc = get_lib().rle_decode(counts, len(counts), h, w, out.ctypes.data)
    return out if rc == 0 else None


def rle_encode_native(mask: np.ndarray) -> bytes:
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    cap = 2 * h * w + 64
    buf = ctypes.create_string_buffer(cap)
    n = get_lib().rle_encode(mask.ctypes.data, h, w, buf, cap)
    if n < 0:
        raise RuntimeError("rle_encode: output buffer too small")
    return buf.raw[:n]


def normalize_image_native(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty(img.shape, np.float32)
    get_lib().normalize_image(img.ctypes.data, img.size, out.ctypes.data)
    return out


def jpeg_info(data: bytes) -> tuple[int, int, int, int]:
    """(width, height, channels before RGB, SOF marker) of a JPEG; raises
    ValueError for a file the decoder does not take."""
    out = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(256)
    if get_lib().idt_jpeg_info(data, len(data), out.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    return tuple(int(v) for v in out)


def jpeg_decode(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG, as libjpeg-turbo's defaults decode it."""
    w, h, _, _ = jpeg_info(data)
    out = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(256)
    if get_lib().idt_jpeg_decode(data, len(data), out.ctypes.data, err, len(err)):
        raise ValueError(err.value.decode())
    return out


def jpeg_encode(rgb: np.ndarray) -> bytes:
    """The bytes Pillow writes for an (H, W, 3) uint8 image saved as a
    default JPEG (`native/jpeg_encode.cpp`)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    cap = h * w * 2 + 2048
    for _ in range(2):
        buf = ctypes.create_string_buffer(cap)
        n = get_lib().idt_jpeg_encode(rgb.ctypes.data, h, w, ctypes.addressof(buf), cap)
        if n >= 0:
            return buf.raw[:n]
        cap = -n
    raise RuntimeError("idt_jpeg_encode: output buffer too small after resizing")


def find_contours_native(mask: np.ndarray) -> list[np.ndarray]:
    """The borders of a 2-D mask's nonzero pixels as (N, 2) int32 (x, y)
    arrays, in the order `geometry.find_contours_numpy` finds them (it lists
    them reversed)."""
    mask = np.ascontiguousarray(mask, np.uint8)
    h, w = mask.shape
    cap_pts, cap_n = 4 * (h + w) + 64, 64
    for _ in range(2):
        points = np.empty((cap_pts, 2), np.int32)
        lengths = np.empty(cap_n, np.int64)
        n = get_lib().idt_find_contours(mask.ctypes.data, h, w, points.ctypes.data, cap_pts,
                                        lengths.ctypes.data, cap_n)
        if n >= 0:
            ends = np.cumsum(lengths[:n])
            return [points[e - k:e] for e, k in zip(ends.tolist(), lengths[:n].tolist())]
        cap_pts, cap_n = int(lengths[0]), max(int(lengths[1]), 2)
    raise RuntimeError("idt_find_contours: buffers too small after resizing")


def fill_poly_native(mask: np.ndarray, polygons, value: int) -> None:
    """cv2.fillPoly(mask, polygons, value) in place on a C-contiguous (H, W)
    uint8 mask; polygons: (N, 2) integer (x, y) arrays."""
    if mask.dtype != np.uint8 or mask.ndim != 2 or not mask.flags.c_contiguous:
        raise ValueError(f"fill_poly takes a C-contiguous (H, W) uint8 mask, got {mask.dtype} "
                         f"{mask.shape}")
    polys = [np.asarray(p, np.int64).reshape(-1, 2) for p in polygons]
    points = np.ascontiguousarray(np.concatenate(polys) if polys else np.zeros((0, 2), np.int64))
    counts = np.array([len(p) for p in polys], np.int64)
    get_lib().idt_fill_poly(mask.ctypes.data, mask.shape[0], mask.shape[1], points.ctypes.data,
                            counts.ctypes.data, len(polys), int(value))


def resample_pass(img: np.ndarray, axis: int, bounds: np.ndarray,
                  weights: np.ndarray) -> np.ndarray:
    """`data/resample._pass` in C++: one 8-bit pass of (H, W[, C]) uint8
    along axis 0 (rows) or 1 (columns)."""
    img = np.ascontiguousarray(img, np.uint8)
    bounds = np.ascontiguousarray(bounds, np.int64)
    weights = np.ascontiguousarray(weights, np.int64)
    n_out, ksize = weights.shape
    if bounds.shape != (n_out, 2) or int((bounds[:, 0] + bounds[:, 1]).max()) > img.shape[axis]:
        raise ValueError("resample_pass: taps outside the image")
    shape = list(img.shape)
    shape[axis] = n_out
    out = np.empty(shape, np.uint8)
    lib = get_lib()
    if axis == 1:
        ch = img.shape[2] if img.ndim == 3 else 1
        lib.idt_resample_h(img.ctypes.data, img.shape[0], img.shape[1], ch, bounds.ctypes.data,
                           weights.ctypes.data, ksize, n_out, out.ctypes.data)
    elif axis == 0:
        lib.idt_resample_v(img.ctypes.data, img[0].size, bounds.ctypes.data,
                           weights.ctypes.data, ksize, n_out, out.ctypes.data)
    else:
        raise ValueError(f"resample_pass: axis {axis}")
    return out


def resize_cubic_native(img: np.ndarray, xofs: np.ndarray, alpha: np.ndarray, yofs: np.ndarray,
                        beta: np.ndarray) -> np.ndarray:
    """`geometry.resize_cubic`'s two passes in C++ on (H, W[, C]) uint8 with
    the taps and weights of `geometry._cubic_coefficients`."""
    img = np.ascontiguousarray(img, np.uint8)
    xofs, alpha, yofs, beta = (np.ascontiguousarray(a, np.int64) for a in (xofs, alpha, yofs, beta))
    h, w = img.shape[:2]
    ch = img.shape[2] if img.ndim == 3 else 1
    out = np.empty((len(yofs), len(xofs)) + img.shape[2:], np.uint8)
    get_lib().idt_resize_cubic(img.ctypes.data, h, w, ch, xofs.ctypes.data, alpha.ctypes.data,
                               len(xofs), yofs.ctypes.data, beta.ctypes.data, len(yofs),
                               out.ctypes.data)
    return out


def uniform_sparse_points_native(mask: np.ndarray, k: int) -> tuple[int, np.ndarray | None]:
    """(foreground pixel count, (k, 2) float64 (x, y) points or None) of
    `geometry.sample_uniform_sparse_points` for a 2-D mask; the points only
    when there are at least k foreground pixels (the branch without RNG)."""
    mask = np.ascontiguousarray(mask, np.uint8)
    out = np.empty((max(k, 1), 2), np.float64)
    n = get_lib().idt_uniform_sparse_points(mask.ctypes.data, mask.shape[0], mask.shape[1], k,
                                            out.ctypes.data)
    return int(n), (out[:k] if n and n >= k else None)
