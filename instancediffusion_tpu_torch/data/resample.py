"""PIL's `Image.resize` for 8-bit images, bit for bit, in numpy: what the
training loader's crops need (BOX halving, BICUBIC to the target size,
NEAREST for instance masks) and the CLI's `--img2img` (LANCZOS) without an
imaging library. The passes run in the native library (`resize`);
`resize_numpy` is the same in numpy.

BOX, BICUBIC and LANCZOS follow Pillow's `Resample.c`:
  * two passes, horizontal then vertical, each rounded to uint8; a pass
    whose size does not change is skipped, and the horizontal pass covers
    only the rows the vertical filter reads
  * per output pixel, center = (i + 0.5) * scale, support = filter support
    * max(scale, 1), taps from int(center - support + 0.5) to
    int(center + support + 0.5) clipped to the input, weights
    filter((j - center + 0.5) / max(scale, 1)) normalised by their sum
    (BOX: 1 on (-0.5, 0.5]; BICUBIC: Keys' cubic with a = -0.5; LANCZOS:
    sinc(x) * sinc(x / 3) on [-3, 3))
  * weights fixed to 22 fractional bits, rounded half away from zero;
    sums started at 1 << 21, shifted right by 22 and clipped to 0..255
NEAREST is Pillow's affine scaling: source index int(x_i), x_0 = in / out / 2,
x_{i+1} = x_i + in / out, summed in float64 (which can fall one short of
floor((i + 0.5) * in / out) where that is a whole number).
"""

from __future__ import annotations

import math

import numpy as np

BOX, BICUBIC, LANCZOS, NEAREST = "box", "bicubic", "lanczos", "nearest"
PRECISION_BITS = 32 - 8 - 2


def _box(x: np.ndarray) -> np.ndarray:
    return ((x > -0.5) & (x <= 0.5)).astype(np.float64)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _sinc(x: np.ndarray) -> np.ndarray:
    safe = np.where(x == 0.0, 1.0, x * math.pi)
    return np.where(x == 0.0, 1.0, np.sin(safe) / safe)


def _lanczos(x: np.ndarray) -> np.ndarray:
    return np.where((x >= -3.0) & (x < 3.0), _sinc(x) * _sinc(x / 3), 0.0)


_FILTERS = {BOX: (_box, 0.5), BICUBIC: (_bicubic, 2.0), LANCZOS: (_lanczos, 3.0)}


def coefficients(in_size: int, out_size: int, method: str) -> tuple[np.ndarray, np.ndarray]:
    """(bounds (out, 2) int64 of (first tap, tap count), weights (out, ksize)
    int64 fixed-point) of one pass, as `precompute_coeffs` and
    `normalize_coeffs_8bpc` compute them."""
    fn, base_support = _FILTERS[method]
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = base_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    live = taps[None, :] < xmax[:, None]
    w = np.where(live, fn(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                          * (1.0 / filterscale)), 0.0)
    total = np.zeros(out_size)
    for k in range(ksize):  # summed in tap order, as the C loop sums
        total = total + w[:, k]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << PRECISION_BITS)).astype(np.int64)
    return np.stack([xmin, xmax], 1), fixed


def _pass(img: np.ndarray, axis: int, bounds: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """One 8-bit pass along `axis` (0: rows, 1: columns) of (H, W[, C])."""
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    out = np.full((len(bounds),) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    n = src.shape[0]
    for k in range(weights.shape[1]):
        idx = np.minimum(bounds[:, 0] + k, n - 1)
        wk = np.where(k < bounds[:, 1], weights[:, k], 0)
        out += src[idx] * wk.reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(out >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """`ImagingScaleAffine`'s source indices: the position starts at
    step / 2 and adds step = in / out once per output pixel (in float64, in
    that order), truncated."""
    step = float(in_size) / out_size
    pos = np.add.accumulate(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
    return pos.astype(np.int64)


def resize(img: np.ndarray, size: tuple[int, int], method: str) -> np.ndarray:
    """`Image.fromarray(img).resize(size, method)` as an array: img (H, W, 3)
    or (H, W) uint8, size (width, height) as PIL takes it. The BOX, BICUBIC
    and LANCZOS passes run in the native library (`native/resample.cpp`)."""
    from instancediffusion_tpu_torch.data._native import resample_pass

    return _resize(img, size, method, resample_pass)


def resize_numpy(img: np.ndarray, size: tuple[int, int], method: str) -> np.ndarray:
    """`resize` with its passes in numpy (`_pass`), the reference the native
    passes are held to."""
    return _resize(img, size, method, _pass)


def _resize(img: np.ndarray, size: tuple[int, int], method: str, run_pass) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize takes (H, W) or (H, W, C) uint8, got {img.dtype} {img.shape}")
    out_w, out_h = size
    h, w = img.shape[:2]
    if (out_w, out_h) == (w, h):
        return img.copy()
    if method == NEAREST:
        return img[_nearest_index(h, out_h)][:, _nearest_index(w, out_w)]
    if method not in _FILTERS:
        raise ValueError(f"unknown resampling method {method!r}")
    vbounds, vweights = coefficients(h, out_h, method)
    out = img
    if out_w != w:
        first = int(vbounds[0, 0])
        last = int(vbounds[-1, 0] + vbounds[-1, 1])
        hb, hw = coefficients(w, out_w, method)
        out = run_pass(img[first:last], 1, hb, hw)
        vbounds = vbounds - np.array([first, 0])
    if out_h != h:
        out = run_pass(out, 0, vbounds, vweights)
    return np.ascontiguousarray(out)
