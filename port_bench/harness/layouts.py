"""Seeded request inputs: layouts (a prompt and per-instance phrases, boxes,
points and optional filled masks) and image seeds.

Every draw comes from `numpy.random.default_rng([seed, *stream])`: the same
seed and stream give the same input whatever order requests run in, and
every seed gives requests of the same sizes (instance counts, image sizes),
so seeds change the content, not the amount of work."""

from __future__ import annotations

import numpy as np

PHRASES = (
    "a cat", "a dog", "a robin", "a wooden bench", "a red car", "a bicycle", "a lamp post",
    "a fox", "a horse", "a sailboat", "a teapot", "a vase of flowers", "an owl", "a kite",
    "a pine tree", "a mailbox", "a backpack", "a guitar", "a pumpkin", "a laptop",
    "a rabbit", "a deer", "a fire hydrant", "a surfboard", "an umbrella", "a parrot",
    "a lighthouse", "a cow", "a sheep", "a bowl of fruit", "a tent", "a windmill",
)
SCENES = ("in a park", "on a beach", "in a kitchen", "in a meadow", "on a city street",
          "in a forest", "by a lake", "in a living room")


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, *stream])


def layout(gen: np.random.Generator, n_instances: int, segs: bool = False,
           seg_size: int = 512) -> dict:
    """A demo meta of `n_instances` instances: boxes of 15-60 % a side, a
    point inside each, and with `segs` a filled ellipse inside each box as
    its (seg_size, seg_size) mask."""
    phrases = [PHRASES[i] for i in gen.choice(len(PHRASES), n_instances, replace=False)]
    locations, points = [], []
    for _ in range(n_instances):
        w, h = gen.uniform(0.15, 0.6, 2)
        x1, y1 = gen.uniform(0.0, 1.0 - w), gen.uniform(0.0, 1.0 - h)
        box = [round(float(v), 4) for v in (x1, y1, x1 + w, y1 + h)]
        locations.append(box)
        points.append([round(float(gen.uniform(box[0] + 0.25 * w, box[2] - 0.25 * w)), 4),
                       round(float(gen.uniform(box[1] + 0.25 * h, box[3] - 0.25 * h)), 4)])
    scene = SCENES[int(gen.integers(len(SCENES)))]
    meta = {"prompt": f"{' and '.join(phrases)} {scene}", "phrases": phrases,
            "locations": locations, "points": points}
    if segs:
        meta["segs"] = [ellipse_mask(b, seg_size) for b in locations]
    return meta


def ellipse_mask(box, size: int) -> np.ndarray:
    """The filled ellipse inscribed in an xyxy box in [0, 1], as a (size,
    size) float32 mask (rows y, columns x)."""
    yy, xx = (np.mgrid[0:size, 0:size] + 0.5) / size
    x1, y1, x2, y2 = box
    cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
    return ((((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2) <= 1.0).astype(np.float32)


def image_seed(gen: np.random.Generator) -> int:
    return int(gen.integers(0, 2**31 - 1))


def strata(gen: np.random.Generator, n: int, k: int) -> list[int]:
    """k rows of a batch of n, one drawn from each of k equal strata, so a
    fault that spares any half of the batch still meets a checked row."""
    edges = [round(i * n / k) for i in range(k + 1)]
    return [int(gen.integers(lo, hi)) for lo, hi in zip(edges, edges[1:])]
