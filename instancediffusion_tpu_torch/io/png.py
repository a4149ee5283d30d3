"""PNG files with zlib and struct alone (no imaging library): the writer
the server and the demo CLI use, and a reader of 8-bit gray, gray +
alpha, RGB and RGBA non-interlaced images with any of the five row
filters."""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> channels: L, RGB, LA, RGBA


def png_bytes(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes: 8-bit RGB, no interlace, filter 0 on
    every row, one zlib stream."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"png_bytes takes (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        body = kind + data
        return struct.pack(">I", len(data)) + body + struct.pack(">I", zlib.crc32(body))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One reconstructed row from its filtered bytes and the row above."""
    if kind == 0:
        return line.copy()
    if kind == 1:  # Sub: a running sum per channel
        sums = np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
        return (sums & 0xFF).astype(np.uint8).reshape(-1)
    if kind == 2:  # Up
        return ((line.astype(np.int64) + prior) & 0xFF).astype(np.uint8)
    if kind not in (3, 4):
        raise ValueError(f"PNG row filter {kind} is not one of 0-4")
    cur, up = line.tolist(), prior.tolist()
    for i in range(len(cur)):  # Average and Paeth read the reconstructed left byte
        left = cur[i - bpp] if i >= bpp else 0
        if kind == 3:
            cur[i] = (cur[i] + ((left + up[i]) >> 1)) & 0xFF
        else:
            upleft = up[i - bpp] if i >= bpp else 0
            cur[i] = (cur[i] + _paeth(left, up[i], upleft)) & 0xFF
    return np.array(cur, np.uint8)


def read_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit L, LA, RGB or RGBA, non-interlaced) -> (H, W, 1, 2,
    3 or 4) uint8. Other bit depths, colour types and interlacing raise
    ValueError."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"PNG of bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}: only 8-bit L / LA / RGB / RGBA without interlace is read")
    c = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    out = np.empty((h, w * c), np.uint8)
    prior = np.zeros(w * c, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prior, c)
    return out.reshape(h, w, c)
