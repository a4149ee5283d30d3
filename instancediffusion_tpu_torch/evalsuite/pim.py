"""Points-in-Mask (PiM) metric — location fidelity for point/scribble
conditioning (copied from `instancediffusion_tpu/evalsuite/pim.py`, which
imports no JAX; the port imports nothing of the JAX package).

Re-implements eval/eval_pim.py (:28-185) without pycocotools: predicted
instance masks (e.g. YOLOv8-seg run on generated images) are greedily
matched to ground-truth masks by IoU (GT-major order, one-to-one,
threshold 0.0 as upstream), then

  * point mode:   is the GT mask's bbox-center inside the matched
                  predicted mask? (eval_pim.py:57-65)
  * scribble mode: fraction of 20 GT-sampled scribble points inside the
                  matched predicted mask (eval_pim.py:47-55)

PiM = mean over images of the per-image mean over matched instances.
Masks arrive as (H, W) binary numpy arrays; RLE inputs can be decoded with
data.geometry.rle_decode. CPU-only numpy.
"""

from __future__ import annotations

import numpy as np


def calculate_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    # two empty masks -> nan, exactly like the reference's unguarded 0/0
    # (eval_pim.py:28-32): inside match_masks, nan compares False against
    # best_iou, so an empty-vs-empty pair can never win the greedy match —
    # returning 0.0 here would let it tie (and win) against later
    # zero-overlap candidates, silently changing pair assignment
    return float(inter / union) if union > 0 else float("nan")


def mask_center(binary_mask: np.ndarray):
    """bbox center of a binary mask as (x, y), or None (eval_pim.py:34-45)."""
    ys, xs = np.where(binary_mask == 1)
    if len(ys) == 0:
        return None
    return (
        int((xs.min() + xs.max()) / 2),
        int((ys.min() + ys.max()) / 2),
    )


def match_masks(gt_masks, pred_masks, iou_threshold: float = 0.0):
    """Greedy one-to-one GT->pred matching by IoU (eval_pim.py:67-90)."""
    pairs = []
    used = set()
    for gi, g in enumerate(gt_masks):
        best_iou, best = -1.0, -1
        for pi, p in enumerate(pred_masks):
            if pi in used:
                continue
            iou = calculate_iou(g, p)
            if iou > best_iou:
                best_iou, best = iou, pi
        if best_iou >= iou_threshold and best >= 0:
            pairs.append((gi, best))
            used.add(best)
    return pairs


def sample_scribble_points(
    mask: np.ndarray, k: int = 20, rng: np.random.Generator | None = None
):
    """k random integer foreground points, sorted by distance to origin,
    as [[x, y], ...] (eval_pim.py:92-120)."""
    rng = rng or np.random.default_rng()
    nz = np.transpose(np.nonzero(mask))
    if len(nz) == 0:
        return [0] * (k * 2)
    idx = rng.choice(len(nz), k, replace=len(nz) < k)
    pts = sorted(nz[idx], key=lambda x: float(np.linalg.norm(x)))
    return [[int(p[1]), int(p[0])] for p in pts]


def point_inside(pred_mask: np.ndarray, gt_mask: np.ndarray):
    c = mask_center(gt_mask)
    if c is None:
        return None
    return 1 if pred_mask[c[1], c[0]] == 1 else 0


def scribble_inside_fraction(pred_mask: np.ndarray, scribbles) -> float:
    inside = [1 if pred_mask[y, x] == 1 else 0 for x, y in scribbles]
    return float(np.mean(inside))


def pim_score(
    per_image: list[tuple[list[np.ndarray], list[np.ndarray]]],
    mode: str = "point",
    rng: np.random.Generator | None = None,
) -> float:
    """per_image: [(gt_masks, pred_masks), ...]. mode: 'point'|'scribble'."""
    rng = rng or np.random.default_rng(0)
    acc_all = []
    for gt_masks, pred_masks in per_image:
        pairs = match_masks(gt_masks, pred_masks, 0.0)
        accs = []
        for gi, pi in pairs:
            if mode == "scribble":
                scr = sample_scribble_points(gt_masks[gi], 20, rng)
                if np.sum(scr) == 0:
                    continue
                accs.append(scribble_inside_fraction(pred_masks[pi], scr))
            else:
                a = point_inside(pred_masks[pi], gt_masks[gi])
                if a is not None:
                    accs.append(a)
        if accs:
            acc_all.append(float(np.mean(accs)))
    acc_all = [a for a in acc_all if not np.isnan(a)]
    return float(np.mean(acc_all)) if acc_all else float("nan")
