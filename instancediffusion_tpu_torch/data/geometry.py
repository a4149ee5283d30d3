"""Host-side conditioning geometry (counterpart of
`instancediffusion_tpu/data/geometry.py`, copied, with numpy in place of
cv2): COCO RLE masks, scribble/polygon point sampling, coordinate rescaling.

  * COCO compressed-RLE decode/encode in NumPy, the decode also through
    the native library (`data/_native.py`)
  * sample_random_points_from_mask, sample_sparse_points_from_mask,
    sample_uniform_sparse_points, reorder_scribbles /
    equally_spaced_sampling_with_replacement, convert_points,
    rescale_box/points/scribbles: the JAX package's, line for line
  * find_contours: the border following of
    cv2.findContours(RETR_LIST, CHAIN_APPROX_NONE) (Suzuki and Abe), the
    same points in the same order, behind mask_boundary_points
  * resize_nearest: cv2.resize(..., INTER_NEAREST)'s index rule
  * fill_poly: cv2.fillPoly on integer vertices (the native library's
    `native/fill_poly.cpp`), which rasterises COCO polygon segmentations
  * resize_cubic: OpenCV's own cv2.resize(..., INTER_CUBIC) on uint8 (see
    its docstring for the one route of cv2 it does not follow)

All random sampling takes an explicit np.random.Generator for determinism."""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# COCO compressed RLE
# ---------------------------------------------------------------------------


def rle_decode(rle: dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str|bytes|list} -> (h, w, 1) uint8 mask;
    compressed counts through the native library (`native/dataops.cpp`),
    `rle_decode_numpy` otherwise and for malformed counts."""
    counts = rle["counts"]
    if not isinstance(counts, list):
        from instancediffusion_tpu_torch.data._native import rle_decode_native

        h, w = rle["size"]
        nat = rle_decode_native(counts.encode("ascii") if isinstance(counts, str) else counts,
                                int(h), int(w))
        if nat is not None:
            return nat[:, :, None]
    return rle_decode_numpy(rle)


def rle_decode_numpy(rle: dict) -> np.ndarray:
    """{'size': [h, w], 'counts': str|bytes|list} -> (h, w, 1) uint8 mask.

    COCO RLE is column-major runs alternating 0/1; the compressed string
    packs run lengths 5 bits at a time (LEB128-style with sign trick and
    delta coding from the second run on)."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, list):  # uncompressed
        runs = np.asarray(counts, dtype=np.int64)
    else:
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        runs = []
        i = 0
        prev = 0
        n = len(counts)
        while i < n:
            x = 0
            k = 0
            more = True
            while more:
                c = counts[i] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
                if not more and (c & 0x10):
                    x |= -1 << (5 * k)
            if len(runs) > 2:
                x += runs[-2]
            runs.append(x)
            prev = x
        runs = np.asarray(runs, dtype=np.int64)
    vals = np.zeros(len(runs), dtype=np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, runs)
    total = h * w
    if flat.size < total:
        flat = np.concatenate([flat, np.zeros(total - flat.size, np.uint8)])
    mask = flat[:total].reshape(w, h).T  # column-major
    return mask[:, :, None]


def rle_encode(mask: np.ndarray) -> dict:
    """(h, w) or (h, w, 1) binary mask -> compressed COCO RLE dict."""
    if mask.ndim == 3:
        mask = mask[:, :, 0]
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).T.reshape(-1)
    # run lengths, starting with a zero-run
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    runs = np.diff(bounds).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    # delta-code then 5-bit pack
    out = bytearray()
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)) and not (x == -1 and (c & 0x10))
            if more:
                c |= 0x20
            out.append(c + 48)
    return {"size": [h, w], "counts": out.decode("ascii")}


def decode_to_binary_mask(rle: dict) -> np.ndarray:
    """decodeToBinaryMask (decode_item.py:73-76): -> (h, w, 1) bool."""
    return rle_decode(rle).astype(bool)


# ---------------------------------------------------------------------------
# Point sampling
# ---------------------------------------------------------------------------


def _sort_by_origin_distance(points):
    return sorted(points, key=lambda p: float(np.hypot(p[0], p[1])))


def sample_random_points_from_mask(
    mask: np.ndarray, k: int, rng: np.random.Generator | None = None
) -> list[float]:
    """k random foreground pixels, sorted by distance to (0,0), flattened
    [x1,y1,...] with x=col, y=row (decode_item.py:110-140)."""
    rng = rng or np.random.default_rng()
    m = mask[:, :, 0]
    nz = np.transpose(np.nonzero(m))
    if len(nz) == 0:
        return [0.0] * (k * 2)
    replace = len(nz) < k
    idx = rng.choice(len(nz), k, replace=replace)
    pts = nz[idx]  # (k, 2) as (row, col)
    pts = sorted(pts, key=lambda x: float(np.linalg.norm(x)))
    out: list[float] = []
    for p in pts:
        out.append(float(p[1]))
        out.append(float(p[0]))
    return out


# the 8 neighbours as (dy, dx), counter-clockwise from the right with y
# growing downwards: OpenCV's chain-code numbering
_DIRS = ((0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1))
_VISITED = 2        # a border pixel passed by a trace
_RIGHT_EDGE = -126  # a border pixel whose right neighbour is background


def _follow_border(img: np.ndarray, y0: int, x0: int, is_hole: bool) -> np.ndarray:
    """Trace the border that starts at foreground pixel (y0, x0) of the
    zero-padded int8 image, marking its pixels; (N, 2) (x, y) points in the
    unpadded image's coordinates."""
    s_end = s = 0 if is_hole else 4  # the background neighbour that began the border
    while True:  # clockwise for the first foreground neighbour
        s = (s - 1) & 7
        dy, dx = _DIRS[s]
        if img[y0 + dy, x0 + dx] != 0 or s == s_end:
            break
    if s == s_end:  # an isolated pixel
        img[y0, x0] = _RIGHT_EDGE
        return np.array([[x0 - 1, y0 - 1]], np.int32)
    y1, x1 = y0 + dy, x0 + dx
    y3, x3 = y0, x0
    pts = []
    while True:
        s_end = s
        while True:  # counter-clockwise from the pixel we came from
            s += 1
            dy, dx = _DIRS[s & 7]
            y4, x4 = y3 + dy, x3 + dx
            if img[y4, x4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:  # the right neighbour was examined: background
            img[y3, x3] = _RIGHT_EDGE
        elif img[y3, x3] == 1:
            img[y3, x3] = _VISITED
        pts.append((x3 - 1, y3 - 1))
        if y4 == y0 and x4 == x0 and y3 == y1 and x3 == x1:
            break
        y3, x3 = y4, x4
        s = (s + 4) & 7
    return np.array(pts, np.int32)


def find_contours(mask: np.ndarray) -> list[np.ndarray]:
    """`find_contours_numpy`'s contours, traced by the native library
    (`native/contours.cpp`)."""
    from instancediffusion_tpu_torch.data._native import find_contours_native

    return find_contours_native(mask != 0)[::-1]


def find_contours_numpy(mask: np.ndarray) -> list[np.ndarray]:
    """cv2.findContours(mask, cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)'s
    contours: every outer and hole border of the nonzero pixels of a 2-D
    mask as (N, 2) int32 (x, y) points, each in OpenCV's order (from the
    border's first pixel in raster order, counter-clockwise for outer
    borders), the borders last found first, as OpenCV lists them."""
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = mask != 0
    found = []
    for y in range(1, h + 1):
        row = img[y]  # a view: traces update it as the scan goes
        # tracing only relabels foreground pixels, so no new start appears
        for x in np.flatnonzero(row[1:w + 1] != row[0:w]) + 1:
            p, prev = row[x], row[x - 1]
            if prev == 0 and p == 1:  # an outer border, not yet traced
                found.append(_follow_border(img, y, x, False))
            elif p == 0 and prev >= 1:  # a hole border
                found.append(_follow_border(img, y, x - 1, True))
    return found[::-1]


def mask_boundary_points(mask: np.ndarray) -> np.ndarray:
    """All boundary pixels of a binary (H, W) mask as (M, 2) (x, y) float,
    the contours of `find_contours` one after another."""
    contours = find_contours(mask.astype(np.uint8))
    if not contours:
        return np.zeros((0, 2), np.float32)
    return np.concatenate(contours, axis=0).astype(np.float32)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST):
    destination pixel i reads source min(floor(i * (1 / (dst / src))),
    src - 1), in float64 as OpenCV computes it."""
    h, w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / h))).astype(np.int64), h - 1)
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / w))).astype(np.int64), w - 1)
    return img[ys][:, xs]


def fill_poly(mask: np.ndarray, polygons, value: int = 1) -> np.ndarray:
    """cv2.fillPoly(mask, polygons, value) (shift 0, LINE_8): every polygon,
    an (N, 2) integer (x, y) array, outlined with 8-connected lines and
    filled by even-odd scan lines, all of them in one edge set. Writes into
    the (H, W) uint8 mask, which must be C-contiguous, and returns it."""
    from instancediffusion_tpu_torch.data._native import fill_poly_native

    fill_poly_native(mask, polygons, value)
    return mask


def _cubic_coefficients(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """(source indices (dst, 4), 11-bit weights (dst, 4)) of one axis as
    cv::resize computes them: fx = float32((i + 0.5) * (1 / (dst / src)) -
    0.5), taps floor(fx) - 1 .. floor(fx) + 2 clamped to the image, Keys'
    cubic with A = -0.75 in float32, each weight * 2048 rounded to even."""
    f32 = np.float32
    fx = ((np.arange(dst) + 0.5) * (1.0 / (float(dst) / src)) - 0.5).astype(f32)
    sx = np.floor(fx).astype(np.int64)
    x = (fx - sx.astype(f32)).astype(f32)
    a, one = f32(-0.75), f32(1.0)
    c0 = ((a * (x + one) - f32(5) * a) * (x + one) + f32(8) * a) * (x + one) - f32(4) * a
    c1 = ((a + f32(2)) * x - (a + f32(3))) * x * x + one
    c2 = ((a + f32(2)) * (one - x) - (a + f32(3))) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    weights = np.rint(np.stack([c0, c1, c2, c3], -1) * f32(2048)).astype(np.int64)
    idx = np.clip(sx[:, None] + np.arange(-1, 3)[None, :], 0, src - 1)
    return idx, weights


def resize_cubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_CUBIC) for
    (H, W) or (H, W, C) uint8, as OpenCV's own resize computes it: a=-0.75
    taps in 11-bit fixed point (`_cubic_coefficients`), the two passes in
    the native library (`native/resample.cpp` says how).

    x86 builds of cv2 that carry Intel IPP (the PyPI wheels) resize through
    IPP instead, in float arithmetic that rounds about one value in 10^4
    the other way where the exact value is within ~1e-5 of a half; the
    tests hold this function to cv2 with `cv2.ipp.setUseIPP(False)`."""
    from instancediffusion_tpu_torch.data._native import resize_cubic_native

    _check_u8(img, "resize_cubic")
    xi, xw = _cubic_coefficients(img.shape[1], width)
    yi, yw = _cubic_coefficients(img.shape[0], height)
    return resize_cubic_native(img, xi, xw, yi, yw)


def _check_u8(img: np.ndarray, name: str) -> None:
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"{name} takes (H, W) or (H, W, C) uint8, got {img.dtype} {img.shape}")


def sample_uniform_sparse_points(
    binary_mask: np.ndarray, k: int, rng: np.random.Generator | None = None
) -> list[tuple[float, float]]:
    """`sample_uniform_sparse_points_numpy`, its ranking in the native
    library (`native/contours.cpp`); masks with fewer than k foreground
    pixels take the numpy path (it draws from rng)."""
    from instancediffusion_tpu_torch.data._native import uniform_sparse_points_native

    n, pts = uniform_sparse_points_native(binary_mask, k)
    if pts is None:
        return sample_uniform_sparse_points_numpy(binary_mask, k, rng)
    return [(float(x), float(y)) for x, y in pts.tolist()]


def sample_uniform_sparse_points_numpy(
    binary_mask: np.ndarray, k: int, rng: np.random.Generator | None = None
) -> list[tuple[float, float]]:
    """Interior sampling (decode_item.py:186-216): rank foreground pixels by
    distance to the centroid, split into k segments, take each segment's
    middle point. Returns [(x, y), ...]."""
    rng = rng or np.random.default_rng()
    fg = np.argwhere(binary_mask == 1)
    if len(fg) == 0:
        return []
    if len(fg) < k:
        return [
            (float(p[1]), float(p[0]))
            for p in (fg[rng.integers(0, len(fg))] for _ in range(k))
        ]
    center = fg.mean(axis=0)
    order = np.argsort(np.linalg.norm(fg - center, axis=1), kind="stable")
    fg = fg[order]
    per = len(fg) // k
    out = []
    for i in range(k):
        seg = fg[i * per : (i + 1) * per]
        p = seg[len(seg) // 2]
        out.append((float(p[1]), float(p[0])))
    return out


def sample_sparse_points_from_mask(
    mask: np.ndarray, k: int, rng: np.random.Generator | None = None
) -> list[float] | None:
    """Mask-polygon point set (decode_item.py:218-254): k/2 uniformly-spaced
    boundary points + k/2 interior points, sorted by distance to origin,
    flattened [x1,y1,...]. None when the mask has no boundary."""
    n_polygons = k // 2
    m = mask[:, :, 0]
    boundary = mask_boundary_points(m)
    if boundary.shape[0] == 0:
        return None
    idx = np.linspace(0, boundary.shape[0] - 1, n_polygons).astype(int)
    sampled_boundary = [(float(x), float(y)) for x, y in boundary[idx]]
    inside = sample_uniform_sparse_points(m, k - len(sampled_boundary), rng)
    pts = _sort_by_origin_distance(inside + sampled_boundary)
    out: list[float] = []
    for x, y in pts:
        out.append(x)
        out.append(y)
    return out


def equally_spaced_sampling_with_replacement(points_list, sample_size):
    """decode_item.py:80-103."""
    if sample_size <= len(points_list):
        gap = len(points_list) // sample_size
        return [points_list[i * gap] for i in range(sample_size)]
    return [
        points_list[(i * len(points_list)) // sample_size % len(points_list)]
        for i in range(sample_size)
    ]


def reorder_scribbles(scribbles):
    """decode_item.py:105-107: sort by distance to origin, resample to 20."""
    scribbles = _sort_by_origin_distance(scribbles)
    scribbles = equally_spaced_sampling_with_replacement(scribbles, 20)
    return _sort_by_origin_distance(scribbles)


# ---------------------------------------------------------------------------
# Coordinate rescaling (inference.py:132-147, utils/input.py:152-159)
# ---------------------------------------------------------------------------


def rescale_box_xywh(bbox, width, height):
    """xywh pixels -> xyxy in [0,1]."""
    return [
        bbox[0] / width,
        bbox[1] / height,
        (bbox[0] + bbox[2]) / width,
        (bbox[1] + bbox[3]) / height,
    ]


def point_from_box(box01):
    return [(box01[0] + box01[2]) / 2.0, (box01[1] + box01[3]) / 2.0]


def rescale_points(point, width, height):
    return [point[0] / float(width), point[1] / float(height)]


def rescale_scribbles(scribbles, width, height):
    return [[s[0] / float(width), s[1] / float(height)] for s in scribbles]


def convert_points(points, width, height):
    """Flat [x1,y1,...] pixel list -> [0,1]-relative (utils/input.py:152-159)."""
    out = list(points)
    for i in range(len(out)):
        if i % 2 == 0:
            out[i] = min(out[i] / width, 1.0)
        else:
            out[i] = min(out[i] / height, 1.0)
    return out
