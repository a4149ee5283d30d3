"""Image bytes to RGB arrays without an imaging library: what
`Image.open(BytesIO(data)).convert("RGB")` returns, as (H, W, 3) uint8,
for the two formats the training records hold.

  * JPEG (FF D8 FF): the native decoder (`native/jpeg.cpp`), which decodes
    sequential and progressive Huffman JPEGs bit for bit as PIL's
    libjpeg-turbo does with its defaults; other JPEG kinds (arithmetic
    coding, lossless, hierarchical, 12-bit, CMYK / YCCK) raise ValueError
    naming the SOF marker or the kind
  * PNG: `io/png.read_png` (8-bit L, LA, RGB, RGBA), gray replicated and
    alpha dropped as convert("RGB") does
Any other format raises ValueError naming it.
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
