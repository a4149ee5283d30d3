"""Attribute-binding evaluation: per-instance CLIP score + 8-way color /
texture classification accuracy (copied from
`instancediffusion_tpu/evalsuite/attribute_binding.py`, which imports no
JAX; the port imports nothing of the JAX package).

Re-implements eval/eval_attribute_binding.py (:19-216): each generated
instance is cropped by its GT box; a CLIP image-text similarity scores the
crop against its colored/textured phrase, and accuracy is whether the crop's
nearest "a {color|texture} object" label prompt matches the injected
attribute (instance ids modulo the 8-entry list, :126-133).

The CLIP judge is pluggable: any callable pair (encode_images,
encode_texts) returning L2-normalizable features, such as
`models/clip_vision.CLIPJudge` (ViT-L/14) or an external judge (e.g.
OpenCLIP) as the reference uses; the metric math itself is backend-free
numpy. Unlike JAX's copy, which encodes one crop or text a call and the
label prompts again for every image, the encoders take batches: one call
for an image's crops, one for its phrases, and the label prompts once per
evaluation. The scores are JAX's.
"""

from __future__ import annotations

import numpy as np

COLOR_LIST = ["black", "white", "red", "green", "yellow", "blue", "pink", "purple"]
TEXTURE_LIST = [
    "rubber", "fluffy", "metallic", "wooden", "plastic", "fabric", "leather", "glass",
]


def attach_attributes(anns: list[dict], mode: str) -> list[str]:
    """Inject a deterministic attribute per instance (annotation id modulo
    the list), returning the colored/textured phrase list
    (eval_attribute_binding.py:126-140)."""
    attrs = COLOR_LIST if mode == "colors" else TEXTURE_LIST
    return [
        f"{attrs[ann['id'] % len(attrs)]} {ann['category_name']}" for ann in anns
    ]


def label_prompts(mode: str) -> list[str]:
    attrs = COLOR_LIST if mode == "colors" else TEXTURE_LIST
    return [f"a {a} object" for a in attrs]


def crop_instances(image: np.ndarray, locations01) -> list[np.ndarray]:
    """Crop (H, W, 3) uint8 by xyxy[0,1] boxes.

    PIL's Image.crop ROUNDS fractional box coordinates (the reference crops
    with image.crop((x0*w, y0*h, x1*w, y1*h)), eval_attribute_binding.py:
    185-189); truncating instead shifts crops by a pixel and changes CLIP
    scores — pinned by test_evalsuite_ref_parity.test_crop_parity_with_pil."""
    h, w = image.shape[:2]
    crops = []
    for x0, y0, x1, y1 in locations01:
        crops.append(
            image[round(y0 * h):round(y1 * h), round(x0 * w):round(x1 * w)]
        )
    return crops


def _norm(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def score_image(
    crops: list[np.ndarray],
    phrases: list[str],
    mode: str,
    encode_images,
    encode_texts,
    label_feats: np.ndarray | None = None,
) -> tuple[float, float]:
    """-> (mean CLIP score, mean attribute accuracy) over this image's
    instances. encode_images: [crop] -> (N, D) features; encode_texts:
    [str] -> (N, D); label_feats: the normalised features of
    `label_prompts(mode)`, encoded here when None."""
    attrs = COLOR_LIST if mode == "colors" else TEXTURE_LIST
    if label_feats is None:
        label_feats = _norm(np.stack(encode_texts(label_prompts(mode))))
    kept = [(crop, phrase) for crop, phrase in zip(crops, phrases) if crop.size]
    if not kept:
        return float("nan"), float("nan")
    img_fs = _norm(np.stack(encode_images([crop for crop, _ in kept])))
    txt_fs = _norm(np.stack(encode_texts([phrase for _, phrase in kept])))
    scores, accs = [], []
    for img_f, txt_f, (_, phrase) in zip(img_fs, txt_fs, kept):
        scores.append(float((img_f * txt_f).sum()))
        gt_idx = attrs.index(phrase.split(" ")[0])
        pred = int(np.argmax(label_feats @ img_f))
        accs.append(1.0 if pred == gt_idx else 0.0)
    return float(np.mean(scores)), float(np.mean(accs))


def attribute_binding_eval(per_image, mode, encode_images, encode_texts):
    """per_image: [(image_uint8, locations01, phrases), ...] ->
    {'clip_score': mean, 'accuracy': mean} (image-mean of instance-means)."""
    label_feats = _norm(np.stack(encode_texts(label_prompts(mode))))
    s_list, a_list = [], []
    for image, locations, phrases in per_image:
        crops = crop_instances(image, locations)
        s, a = score_image(crops, phrases, mode, encode_images, encode_texts, label_feats)
        if not np.isnan(s):
            s_list.append(s)
        if not np.isnan(a):
            a_list.append(a)
    return {
        "clip_score": float(np.mean(s_list)) if s_list else float("nan"),
        "accuracy": float(np.mean(a_list)) if a_list else float("nan"),
    }
