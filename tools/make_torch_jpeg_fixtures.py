"""Write the JPEG fixtures of the port's loader tests and of chip_smoke.py's
trainer phase into tests/torch_fixtures/jpeg/, with expected.json.

    python tools/make_torch_jpeg_fixtures.py

Needs PIL and the JAX package (it runs where both are installed; the GPU
host has neither, so the files and their hashes are committed). Images are
procedural numpy scenes (gradients, discs, bars, mild noise) from numpy
seed 0, at COCO-like sizes and one with a short side of 1024 (the loader's
BOX halving), encoded by PIL at the settings COCO-style data carries: 4:2:0
q75 (PIL's default), 4:4:4 q95, 4:2:2, grayscale, a restart interval,
optimised Huffman tables, progressive, and a size that is not a multiple of
the MCU. expected.json gives, per file: its (width, height), PIL's mode,
the SHA-256 of PIL's `convert("RGB")` bytes and of the JAX package's
`center_crop_image(image, 512, None)` array.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")

# name, (width, height), gray, PIL save options
FIXTURES = (
    ("coco_640x480_q75_420.jpg", (640, 480), False, {}),
    ("coco_480x640_q95_444.jpg", (480, 640), False, {"quality": 95, "subsampling": 0}),
    ("coco_500x375_q85_422.jpg", (500, 375), False, {"quality": 85, "subsampling": 1}),
    ("gray_427x640_q75.jpg", (427, 640), True, {}),
    ("restart_640x427_q80.jpg", (640, 427), False, {"quality": 80, "restart_marker_blocks": 6}),
    ("optimized_612x612_q90.jpg", (612, 612), False, {"quality": 90, "optimize": True}),
    ("progressive_640x480_q75.jpg", (640, 480), False, {"progressive": True}),
    ("odd_333x251_q70_420.jpg", (333, 251), False, {"quality": 70}),
    ("large_1280x1024_q75.jpg", (1280, 1024), False, {}),
)


def scene(w: int, h: int, rng: np.random.Generator) -> np.ndarray:
    """(h, w, 3) uint8: a smooth background, a few discs and bars, noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = rng.uniform(40, 200, 3)
    img = np.stack([base[c] + 50 * np.sin(x / rng.uniform(40, 120) + c)
                    * np.cos(y / rng.uniform(40, 120) - c) for c in range(3)], -1)
    for _ in range(6):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(20, min(w, h) / 3)
        img[(x - cx) ** 2 + (y - cy) ** 2 < r * r] = rng.uniform(0, 255, 3)
    for _ in range(3):
        x0, y0 = rng.integers(0, w - 10), rng.integers(0, h - 10)
        img[y0:y0 + int(rng.integers(8, 60)), x0:x0 + int(rng.integers(30, 200))] = \
            rng.uniform(0, 255, 3)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def main() -> int:
    from PIL import Image

    sys.path.insert(0, ROOT)
    from instancediffusion_tpu.data.jsondataset import center_crop_image

    os.makedirs(OUT, exist_ok=True)
    rng = np.random.default_rng(0)
    expected = {}
    for name, (w, h), gray, opts in FIXTURES:
        im = Image.fromarray(scene(w, h, rng))
        if gray:
            im = im.convert("L")
        buf = io.BytesIO()
        im.save(buf, format="JPEG", **opts)
        data = buf.getvalue()
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        dec = Image.open(io.BytesIO(data))
        rgb = dec.convert("RGB")
        crop, _, _ = center_crop_image(rgb, 512, None)
        expected[name] = {
            "size": [w, h], "mode": dec.mode, "bytes": len(data), "save_options": opts,
            "rgb_sha256": hashlib.sha256(np.asarray(rgb).tobytes()).hexdigest(),
            "center_crop_512_sha256": hashlib.sha256(
                np.ascontiguousarray(crop).tobytes()).hexdigest(),
        }
        print(f"{name}: {len(data)} bytes, {dec.mode}")
    with open(os.path.join(OUT, "expected.json"), "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(e["bytes"] for e in expected.values())
    print(f"{len(expected)} files, {total} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
