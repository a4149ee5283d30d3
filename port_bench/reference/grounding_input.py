"""Host-side grounding preparation (counterpart of
`instancediffusion_tpu/data/grounding_input.py`, inference half).

Turns a demo meta dict (phrases, locations, points, scribbles, polygons,
segs) into the zero-padded (max_objs) NumPy bundle UniFusion reads, and
splits a meta into the single-instance metas of the Multi-Instance Sampler
(`prepare_instance_meta`). The scribble, polygon and seg widths are
arguments (the JAX package keeps them as module constants), so a reduced
config needs no patching.
"""

from __future__ import annotations

import numpy as np

N_SCRIBBLE_POINTS = 20
N_POLYGON_POINTS = 256
SEG_SIZE = 512

# phrase_embeddings entry meaning "this slot has a phrase (text_masks = 1);
# its pooled CLIP vector is injected later on the device"
DEFER_EMBEDDING = "defer-embedding"


def zero_grounding_np(batch: int, max_objs: int = 30, in_dim: int = 768,
                      n_scribble_points: int = N_SCRIBBLE_POINTS,
                      n_polygon_points: int = N_POLYGON_POINTS,
                      seg_size: int = SEG_SIZE) -> dict[str, np.ndarray]:
    z = lambda *shape: np.zeros((batch, max_objs) + shape, np.float32)
    return {
        "boxes": z(4),
        "masks": z(),
        "text_masks": z(),
        "positive_embeddings": z(in_dim),
        "scribbles": z(n_scribble_points * 2),
        "polygons": z(n_polygon_points * 2),
        "segs": z(seg_size, seg_size),
        "points": z(2),
    }


def prepare_grounding(meta: dict, phrase_embeddings: list, batch: int = 1,
                      max_objs: int = 30, in_dim: int = 768,
                      n_scribble_points: int = N_SCRIBBLE_POINTS,
                      n_polygon_points: int = N_POLYGON_POINTS,
                      seg_size: int = SEG_SIZE) -> dict[str, np.ndarray]:
    """meta carries per-instance lists: locations (xyxy in [0, 1]) and
    optional points / scribbles / polygons / segs. phrase_embeddings[i] is
    the (in_dim,) pooled CLIP feature of phrase i, None (no phrase) or
    DEFER_EMBEDDING. Returns the bundle repeated `batch` times."""
    out = zero_grounding_np(1, max_objs, in_dim, n_scribble_points,
                            n_polygon_points, seg_size)
    locations = meta["locations"]
    n = min(len(locations), max_objs)
    polygons = meta.get("polygons") or [None] * n
    scribbles = meta.get("scribbles") or [None] * n
    segs = meta.get("segs")
    points = meta.get("points") or [None] * n

    for i in range(n):
        out["boxes"][0, i] = np.asarray(locations[i], np.float32)
        out["masks"][0, i] = 1.0
        if phrase_embeddings[i] is not None:
            out["text_masks"][0, i] = 1.0
            if phrase_embeddings[i] is not DEFER_EMBEDDING:
                out["positive_embeddings"][0, i] = np.asarray(
                    phrase_embeddings[i], np.float32).reshape(-1)
        if polygons[i] is not None:
            out["polygons"][0, i] = np.asarray(polygons[i], np.float32)
        if scribbles[i] is not None:
            out["scribbles"][0, i] = np.asarray(scribbles[i], np.float32)
        if segs is not None and len(segs) > i and segs[i] is not None:
            out["segs"][0, i] = np.asarray(segs[i], np.float32).reshape(seg_size, seg_size)
        if points[i] is not None:
            out["points"][0, i] = np.asarray(points[i], np.float32)

    # text_mask: a scalar or per-instance multipliers of text_masks
    tm = meta.get("text_mask")
    if tm is not None:
        mult = np.ones(max_objs, np.float32)
        if isinstance(tm, (int, float)):
            mult *= tm
        else:
            for i, v in enumerate(tm):
                mult[i] = v
        out["text_masks"][0] *= mult

    return {k: np.repeat(v, batch, axis=0) for k, v in out.items()}


def prepare_instance_meta(meta: dict, i: int) -> dict:
    """Single-instance meta for a MIS trajectory (utils/input.py:130-144):
    instance phrase doubles as the prompt."""
    return {
        "phrases": [meta["phrases"][i]],
        "locations": [meta["locations"][i]],
        "polygons": [meta["polygons"][i]] if meta.get("polygons") else None,
        "segs": [meta["segs"][i]] if meta.get("segs") is not None else None,
        "scribbles": [meta["scribbles"][i]] if meta.get("scribbles") else None,
        "points": [meta["points"][i]] if meta.get("points") else None,
        "alpha_type": meta.get("alpha_type"),
        "prompt": meta["phrases"][i],
    }
