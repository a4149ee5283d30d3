"""Pluggable model backends for the labeling pipeline (counterpart of
`instancediffusion_tpu/datagen/backends.py`: the Protocols, the COCO oracle
and the zero embedder copied; the CLIP phrase embedder on the port's
pipeline).

The reference's labeling fleet (dataset-generation/
submitit_automatic_label_ram_save_json.py:366-516) hardwires four external
pretrained models: RAM (tagging), GroundingDINO (open-vocabulary
detection), SAM (box-prompted segmentation), BLIP-2 (instance captions),
plus CLIP for phrase embeddings. None of those packages or checkpoints are
part of InstanceDiffusion itself, so here each stage is a small Protocol;
`datagen.label.LabelingPipeline` owns everything that IS InstanceDiffusion
logic (sharding, score filtering, NMS, the caption-composition rule, RLE
encoding, the record schema) and treats the models as plug-ins.

Shipped implementations:
  * CocoOracleBackend — tags/boxes/masks/captions straight from COCO-style
    ground-truth annotations. Deterministic and asset-free: it makes the
    whole pipeline runnable (and testable) in any environment, and lets a
    user bootstrap training JSONs from an annotated dataset through the
    exact path a model fleet would use.
  * ClipPhraseEmbedder / zero_phrase_embedder — the `text_embedding_before`
    producer (CLIP pooled pre-projection feature, reference :90-98), on
    the port's CLIP tower on the card, one batched encode per set of new
    phrases.

Adapters for the real zoo models are user-side glue: wrap each model in a
function with the Protocol signature below and hand it to LabelingPipeline
— no other integration point exists or is needed. (The JAX package's
`backends_zoo.py` adapters need downloaded model weights and are not
ported.)
"""

from __future__ import annotations

from typing import Protocol

import numpy as np


class Tagger(Protocol):
    """image (H,W,3) uint8 -> open-vocabulary tag list (reference RAM,
    :468-476; tags are joined with ', ' for the detector prompt)."""

    def __call__(self, image: np.ndarray) -> list[str]: ...


class Detector(Protocol):
    """(image, tags) -> (boxes (N,4) float32 pixel xyxy, scores (N,),
    phrases len-N). Reference GroundingDINO :180-212 + cxcywh->xyxy
    rescale :487-491; the text_threshold phrase extraction lives inside
    the model wrapper, the box_threshold/NMS filtering in the pipeline."""

    def __call__(
        self, image: np.ndarray, tags: list[str]
    ) -> tuple[np.ndarray, np.ndarray, list[str]]: ...


class Segmenter(Protocol):
    """(image, boxes (N,4) pixel xyxy) -> (N,H,W) bool masks (reference
    SAM predict_torch with box prompts, :500-508)."""

    def __call__(self, image: np.ndarray, boxes: np.ndarray) -> np.ndarray: ...


class Captioner(Protocol):
    """(image, box pixel xyxy) -> instance caption for the crop
    (reference BLIP-2 beam search, :101-113). Only called for instances
    with box area >= the pipeline's min_caption_area."""

    def __call__(self, image: np.ndarray, box: np.ndarray) -> str: ...


class PhraseEmbedder(Protocol):
    """phrases -> (N, 768) float32 CLIP pooled pre-projection features
    (reference get_clip_feature_text, :90-98)."""

    def __call__(self, phrases: list[str]) -> np.ndarray: ...


# ---------------------------------------------------------------------------
# Asset-free oracle backend (COCO-style ground truth)
# ---------------------------------------------------------------------------


class CocoOracleBackend:
    """Tagger+Detector+Segmenter+Captioner from COCO-style GT annotations.

    The 'model' is the annotation file: tags are the image's category
    names, detections are the GT boxes at score 1.0, masks are the GT
    segmentations, captions are the category names. Oracle output is the
    upper bound a real fleet approximates — useful both as the pipeline's
    in-env executable backend and for generating clean training JSONs
    from any human-annotated source.
    """

    def __init__(self, instances_json: str):
        from instancediffusion_tpu_torch.evalsuite.coco_eval import CocoAnnotations

        self.coco = CocoAnnotations(instances_json)
        self._by_name: dict[str, int] = {}
        for img_id, info in self.coco.imgs.items():
            self._by_name[info["file_name"]] = img_id
        self._current: int | None = None

    def select(self, file_name: str) -> bool:
        """Point the oracle at one image (by COCO file_name); the
        stage calls below then answer for that image."""
        img_id = self._by_name.get(file_name)
        self._current = img_id
        return img_id is not None

    def _anns(self):
        assert self._current is not None, "call select(file_name) first"
        return [
            a
            for a in self.coco.img_anns[self._current]
            if not a.get("iscrowd", 0)
        ]

    def tag(self, image: np.ndarray) -> list[str]:
        names = [
            self.coco.cats[a["category_id"]]["name"] for a in self._anns()
        ]
        return sorted(set(names))

    def detect(self, image, tags):
        anns = self._anns()
        boxes = np.asarray(
            [
                [b[0], b[1], b[0] + b[2], b[1] + b[3]]
                for b in (a["bbox"] for a in anns)
            ],
            np.float32,
        ).reshape(-1, 4)
        scores = np.ones(len(anns), np.float32)
        phrases = [self.coco.cats[a["category_id"]]["name"] for a in anns]
        return boxes, scores, phrases

    def segment(self, image, boxes):
        """The masks of the annotations whose boxes are `boxes` (the
        detections the pipeline kept after its score filter and NMS), in
        their order. JAX's oracle returns every annotation's mask, so it
        fails the pipeline's count check once NMS drops a box; with no box
        dropped both give the same masks."""
        anns = self._anns()
        info = self.coco.imgs[self._current]
        every = self.detect(image, None)[0]
        picked: list[int] = []
        for box in np.asarray(boxes, np.float32).reshape(-1, 4):
            picked.append(next(i for i in range(len(anns))
                               if i not in picked and np.array_equal(every[i], box)))
        if not picked:
            return np.zeros((0, info["height"], info["width"]), bool)
        return np.stack([self.coco.ann_to_mask(anns[i], info)[:, :, 0] > 0 for i in picked])

    def caption(self, image, box):
        # GT has no instance captions; the pipeline's composition rule
        # then reduces to the category name, like the reference's
        # small-instance path (:123-126)
        return ""


# ---------------------------------------------------------------------------
# Phrase embedders
# ---------------------------------------------------------------------------


def zero_phrase_embedder(phrases: list[str]) -> np.ndarray:
    """Weight-free fallback: UniFusion replaces null/padded embeddings
    with learned nulls, so zeros degrade to location-only conditioning."""
    return np.zeros((len(phrases), 768), np.float32)


class ClipPhraseEmbedder:
    """Batched phrase -> CLIP pooled pre-projection features on the port's
    text tower (`pipeline.encode_phrases`: one batched encode per set of new
    phrases, memoized across images — eval_local embeds the same 80
    category names thousands of times). The checkpoint loads on `device`
    (the card by default) in the entry points' dtype (bf16 on the card,
    float32 on the CPU)."""

    def __init__(self, ckpt_path: str, device="cuda"):
        import torch

        from instancediffusion_tpu_torch.config import Config
        from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline, default_dtype

        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ClipPhraseEmbedder: device cuda but torch.cuda.is_available() "
                               "is false (pass device='cpu' to run on the CPU)")
        self._pipe = InstanceDiffusionPipeline.from_checkpoint(
            ckpt_path, Config(), device=device, dtype=default_dtype(device))
        self._cache: dict[str, np.ndarray] = {}

    def __call__(self, phrases: list[str]) -> np.ndarray:
        new = sorted({p for p in phrases if p not in self._cache})
        if new:
            embs = self._pipe.encode_phrases(new)
            for p, e in zip(new, np.asarray(embs, np.float32)):
                self._cache[p] = e
        return np.stack([self._cache[p] for p in phrases]) if phrases else (
            np.zeros((0, 768), np.float32)
        )
