"""Image bytes to RGB arrays and back without an imaging library: what
`Image.open(BytesIO(data)).convert("RGB")` returns, as (H, W, 3) uint8,
for the two formats the training records hold, and the JPEG bytes Pillow
writes (`encode_jpeg`).

  * JPEG (FF D8 FF): the native decoder (`native/jpeg.cpp`), which decodes
    sequential and progressive Huffman JPEGs bit for bit as PIL's
    libjpeg-turbo does with its defaults; other JPEG kinds (arithmetic
    coding, lossless, hierarchical, 12-bit, CMYK / YCCK) raise ValueError
    naming the SOF marker or the kind
  * PNG: `io/png.read_png` (8-bit L, LA, RGB, RGBA), gray replicated and
    alpha dropped as convert("RGB") does
Any other format raises ValueError naming it.

`encode_jpeg` writes what `Image.fromarray(x).convert("RGB").save(buf,
format="JPEG")` writes, byte for byte: libjpeg-turbo's defaults (quality
75, 4:2:0, Annex K's Huffman tables, JFIF 1.01). It runs in the native
library (`native/jpeg_encode.cpp`); `encode_jpeg_numpy` is the same in
numpy, the reference the native encoder is held to.
"""

from __future__ import annotations

import numpy as np

from instancediffusion_tpu_torch.data import _native
from instancediffusion_tpu_torch.io.png import SIGNATURE as PNG_SIGNATURE
from instancediffusion_tpu_torch.io.png import read_png

JPEG_MAGIC = b"\xff\xd8\xff"
# formats recognised only to name them in the error
_OTHER_MAGIC = ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                (b"\x00\x00\x01\x00", "ICO"))


def image_format(data: bytes) -> str:
    """'JPEG', 'PNG', or the name of another format the bytes start with."""
    if data[:3] == JPEG_MAGIC:
        return "JPEG"
    if data[:8] == PNG_SIGNATURE:
        return "PNG"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WEBP"
    for magic, name in _OTHER_MAGIC:
        if data.startswith(magic):
            return name
    return "unknown"


def decode_image(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of JPEG or PNG bytes."""
    fmt = image_format(data)
    if fmt == "JPEG":
        return _native.jpeg_decode(data)
    if fmt == "PNG":
        img = read_png(data)
        if img.shape[2] <= 2:  # L, LA
            return np.ascontiguousarray(np.repeat(img[:, :, :1], 3, axis=2))
        return np.ascontiguousarray(img[:, :, :3])
    raise ValueError(f"image format {fmt} is not decoded (JPEG and PNG are; first bytes "
                     f"{data[:8].hex()})")


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """The default-quality JPEG Pillow writes for an (H, W, 3) uint8 image."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or 0 in rgb.shape:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got {rgb.dtype} {rgb.shape}")
    return _native.jpeg_encode(rgb)


# -- the encoder in numpy ----------------------------------------------------

ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                   48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29,
                   22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
                   47, 55, 62, 63])
# Annex K's quantisation tables in natural order and Huffman tables as DHT
# bodies (16 code counts by length, then the symbols)
_QUANT = (np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16,
                    24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109,
                    103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103, 121, 120, 101,
                    72, 92, 95, 98, 112, 100, 103, 99]),
          np.array([17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 + [24, 26, 56]
                   + [99] * 5 + [47, 66] + [99] * 38))
_DHT = {
    0x00: "00010501010101010100000000000000000102030405060708090a0b",
    0x01: "00030101010101010101010000000000000102030405060708090a0b",
    0x10: "0002010303020403050504040000017d01020300041105122131410613516107227114328191a108"
          "2342b1c11552d1f02433627282090a161718191a25262728292a3435363738393a434445464748494a"
          "535455565758595a636465666768696a737475767778797a838485868788898a9293949596979899"
          "9aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4"
          "e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    0x11: "00020102040403040705040400010277000102031104052131061241510761711322328108144291"
          "a1b1c109233352f0156272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
          "535455565758595a636465666768696a737475767778797a82838485868788898a9293949596979899"
          "9aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5"
          "e6e7e8e9eaf2f3f4f5f6f7f8f9fa",
}


def _huffman_codes(body: bytes) -> dict:
    """symbol -> (code, length), canonical in order of length."""
    codes, code, k = {}, 0, 16
    for length in range(1, 17):
        for _ in range(body[length - 1]):
            codes[body[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _quant_tables() -> list[np.ndarray]:
    return [np.clip((q * 50 + 50) // 100, 1, 255) for q in _QUANT]


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """libjpeg's ISLOW forward DCT (jfdctint.c) of (..., 8, 8) int64 blocks
    of samples less 128: the rows, then the columns; the output is the
    DCT scaled by 8."""
    d = lambda x, n: (x + (1 << (n - 1))) >> n

    def one_pass(x, first):
        sh = 11 if first else 15
        t0, t7 = x[..., 0] + x[..., 7], x[..., 0] - x[..., 7]
        t1, t6 = x[..., 1] + x[..., 6], x[..., 1] - x[..., 6]
        t2, t5 = x[..., 2] + x[..., 5], x[..., 2] - x[..., 5]
        t3, t4 = x[..., 3] + x[..., 4], x[..., 3] - x[..., 4]
        t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
        out = np.empty_like(x)
        out[..., 0] = (t10 + t11) * 4 if first else d(t10 + t11, 2)
        out[..., 4] = (t10 - t11) * 4 if first else d(t10 - t11, 2)
        z1 = (t12 + t13) * 4433
        out[..., 2] = d(z1 + t13 * 6270, sh)
        out[..., 6] = d(z1 - t12 * 15137, sh)
        z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
        z5 = (z3 + z4) * 9633
        z3 = z3 * -16069 + z5
        z4 = z4 * -3196 + z5
        z1, z2 = z1 * -7373, z2 * -20995
        out[..., 7] = d(t4 * 2446 + z1 + z3, sh)
        out[..., 5] = d(t5 * 16819 + z2 + z4, sh)
        out[..., 3] = d(t6 * 25172 + z2 + z3, sh)
        out[..., 1] = d(t7 * 12299 + z1 + z4, sh)
        return out

    rows = one_pass(blocks, True)
    return np.swapaxes(one_pass(np.swapaxes(rows, -1, -2), False), -1, -2)


def _quantize(coef: np.ndarray, table: np.ndarray) -> np.ndarray:
    """jcdctmgr.c's quantisation: |x| plus a correction, times a reciprocal,
    shifted (`compute_reciprocal` of each divisor table * 8)."""
    div = (table * 8).astype(np.int64)
    b = np.floor(np.log2(div)).astype(np.int64)
    r = 16 + b
    fq, fr = (1 << r) // div, (1 << r) % div
    c = div // 2
    exact = fr == 0
    fq = np.where(exact, fq >> 1, np.where(fr > div // 2, fq + 1, fq))
    r = np.where(exact, r - 1, r)
    c = np.where(~exact & (fr <= div // 2), c + 1, c)
    a = np.abs(coef)
    q = ((a + c) * fq) >> r
    return np.where(coef < 0, -q, q)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(rows, cols) -> (rows / 8, cols / 8, 8, 8)."""
    r, c = plane.shape
    return plane.reshape(r // 8, 8, c // 8, 8).swapaxes(1, 2)


def encode_jpeg_numpy(rgb: np.ndarray) -> bytes:
    """`encode_jpeg` in numpy (the Huffman coding in a Python loop)."""
    h, w = rgb.shape[:2]
    mcux, mcuy = -(-w // 16), -(-h // 16)
    x = np.pad(rgb.astype(np.int64), ((0, mcuy * 16 - h), (0, mcux * 16 - w), (0, 0)),
               mode="edge")
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    half, off = 1 << 15, 128 << 16
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + off + half - 1) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + off + half - 1) >> 16
    # h2v2 on the even-row image, bias 1, 2, 1, ... along a row; chroma rows
    # past ceil(h / 2) repeat the last one
    crows = -(-h // 2)
    bias = np.tile([1, 2], mcux * 4)

    def down(p):
        s = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias) >> 2
        return np.concatenate([s[:crows], np.repeat(s[crows - 1:crows], len(s) - crows, 0)])

    quant = _quant_tables()
    coefs = []
    for plane, t in ((y, 0), (down(cb), 1), (down(cr), 1)):
        blocks = _fdct_islow(_blocks(plane) - 128)
        coefs.append(_quantize(blocks.reshape(*blocks.shape[:2], 64), quant[t].reshape(64)))
    # luma blocks past ceil(w / 8) x ceil(h / 8): zeros with the DC of the
    # block before in the MCU (the row above's last block for a dummy row)
    lum = coefs[0]
    bw, bh = -(-w // 8), -(-h // 8)
    if bw % 2:
        lum[:, bw:] = 0
        lum[:, bw, 0] = lum[:, bw - 1, 0]
    if bh % 2:
        lum[bh:] = 0
        lum[bh, :, 0] = np.repeat(lum[bh - 1, 1::2, 0], 2)

    tabs = {k: bytes.fromhex(v) for k, v in _DHT.items()}
    huff = {k: _huffman_codes(v) for k, v in tabs.items()}
    out = bytearray(b"\xff\xd8")

    def seg(marker, body):
        out.extend(bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body)

    seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t in range(2):
        seg(0xDB, bytes([t]) + bytes(quant[t].astype(np.uint8)[ZIGZAG]))
    seg(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
        + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for k in (0x00, 0x10, 0x01, 0x11):
        seg(0xC4, bytes([k]) + tabs[k])
    seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))

    acc, nacc = 0, 0

    def put(code, size):
        nonlocal acc, nacc
        acc, nacc = (acc << size) | (code & ((1 << size) - 1)), nacc + size
        while nacc >= 8:
            nacc -= 8
            byte = (acc >> nacc) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << nacc) - 1

    last = [0, 0, 0]
    for my in range(mcuy):
        for mx in range(mcux):
            for ci, n in ((0, 2), (1, 1), (2, 1)):
                dc, ac = huff[0x00 if ci == 0 else 0x01], huff[0x10 if ci == 0 else 0x11]
                for by in range(n):
                    for bx in range(n):
                        zz = coefs[ci][my * n + by, mx * n + bx][ZIGZAG].tolist()
                        diff, last[ci] = zz[0] - last[ci], zz[0]
                        nb = abs(diff).bit_length()
                        put(*dc[nb])
                        if nb:
                            put(diff - 1 if diff < 0 else diff, nb)
                        run = 0
                        for v in zz[1:]:
                            if not v:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac[0xF0])
                                run -= 16
                            nb = abs(v).bit_length()
                            put(*ac[(run << 4) + nb])
                            put(v - 1 if v < 0 else v, nb)
                            run = 0
                        if run:
                            put(*ac[0x00])
    if nacc:
        byte = ((acc << (8 - nacc)) | (0xFF >> nacc)) & 0xFF
        out.append(byte)
        if byte == 0xFF:
            out.append(0)
    return bytes(out + b"\xff\xd9")
