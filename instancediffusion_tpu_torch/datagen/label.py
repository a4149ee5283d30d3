"""The labeling pipeline on the port: images -> per-image training JSONs
(counterpart of `instancediffusion_tpu/datagen/label.py`; its pure pieces
are copied, the image codecs are the port's own: `data/jpeg.encode_jpeg`
writes the JPEG Pillow writes, `data/jpeg.decode_image` reads JPEG and PNG).

A re-design of dataset-generation/
submitit_automatic_label_ram_save_json.py — everything that is
InstanceDiffusion logic runs here with NumPy + the port's own RLE
codec and CLIP tower; the four zoo models are Protocol plug-ins
(datagen.backends). What the reference does per image (:443-516):

  tag -> detect (score filter, :196) -> NMS (:495-497) -> segment
  -> per instance: RLE (:232-239), bbox xywh (:252-254), BLIP caption
  for area >= 32x32 with category-prefix rule (:105-126), CLIP phrase
  embeddings -> record (:276-326) -> write label_{name}.json (:266-268)

with contiguous job sharding over --num_jobs (:434-440). Differences by
design: phrase embedding is batched per image (one device call, not one
per phrase), already-written outputs are skipped for cheap resume (the
reference recomputes), and empty detections write no file (same effect as
the reference's `except: continue`).

CLI:
  python -m instancediffusion_tpu_torch.datagen.label \
      --train_data_path entries.json --output_dir OUT \
      [--instances_json coco.json]  # oracle backend
      [--ckpt model.pth]            # real CLIP phrase embeddings (on --device)
      [--num_jobs N --job_index I] [--box_threshold .25 --iou_threshold .5]
      [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import json
import os

import numpy as np

from instancediffusion_tpu_torch.data import geometry as geo
from instancediffusion_tpu_torch.data.jpeg import decode_image, encode_jpeg


# ---------------------------------------------------------------------------
# Pure pieces
# ---------------------------------------------------------------------------


def box_nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float
            ) -> list[int]:
    """Greedy NMS, torchvision.ops.nms semantics (the reference's :495):
    keep boxes in descending score order, drop any with IoU > threshold
    against an already-kept box. Returns kept indices, score-sorted."""
    if len(boxes) == 0:
        return []
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    order = np.argsort(-scores, kind="stable")
    keep: list[int] = []
    while order.size:
        i = order[0]
        keep.append(int(i))
        rest = order[1:]
        ix1 = np.maximum(x1[i], x1[rest])
        iy1 = np.maximum(y1[i], y1[rest])
        ix2 = np.minimum(x2[i], x2[rest])
        iy2 = np.minimum(y2[i], y2[rest])
        inter = np.maximum(0.0, ix2 - ix1) * np.maximum(0.0, iy2 - iy1)
        iou = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-9)
        order = rest[iou <= iou_threshold]
    return keep


def compose_instance_caption(category: str, model_caption: str) -> str:
    """Reference :117-119: prefix the category when the captioner's text
    does not already mention it; empty captioner output -> category."""
    if not model_caption:
        return category
    if category and category.lower() not in model_caption.lower():
        return f"{category}. {model_caption}"
    return model_caption


def base_anno(bbox_xywh, pred_score, mask_value, rle, category_name, area
              ) -> dict:
    """The exact anno field set (:307-326)."""
    return {
        "id": 0,
        "isfake": 0,
        "isreflected": 0,
        "bbox": bbox_xywh,
        "mask_value": mask_value,
        "mask": rle,
        "pred_score": pred_score,
        "category_id": 0,
        "data_id": 0,
        "category_name": category_name,
        "text_embedding_before": "",
        "caption": "",
        "blip_clip_embeddings": "",
        "is_stuff": 0,
        "is_thing": 1,
        "area": area,
    }


def _b64_floats(arr: np.ndarray) -> str:
    return base64.b64encode(np.asarray(arr, np.float32).tobytes()).decode()


def encode_image_b64(image: np.ndarray) -> str:
    """(H,W,3) uint8 -> base64 JPEG (reference :271-274): the bytes Pillow's
    default JPEG save writes."""
    return base64.b64encode(encode_jpeg(np.ascontiguousarray(image, np.uint8))).decode()


def shard_bounds(n: int, num_jobs: int, job_index: int) -> tuple[int, int]:
    """Contiguous chunks, reference :437-439 arithmetic."""
    per = n // num_jobs + 1
    return job_index * per, min((job_index + 1) * per, n)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class LabelingPipeline:
    def __init__(
        self,
        tagger,
        detector,
        segmenter,
        captioner,
        embedder,
        box_threshold: float = 0.25,
        iou_threshold: float = 0.5,
        min_caption_area: float = 32 * 32,
        dataset_name: str = "instancediffusion-tpu-datagen",
    ):
        self.tagger = tagger
        self.detector = detector
        self.segmenter = segmenter
        self.captioner = captioner
        self.embedder = embedder
        self.box_threshold = box_threshold
        self.iou_threshold = iou_threshold
        self.min_caption_area = min_caption_area
        self.dataset_name = dataset_name

    def label_image(
        self, image: np.ndarray, caption: str, file_name: str
    ) -> dict | None:
        """One image -> one training record, or None when nothing
        survives detection (the reference skips such images)."""
        tags = self.tagger(image)
        boxes, scores, phrases = self.detector(image, tags)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        scores = np.asarray(scores, np.float32).reshape(-1)

        keep = np.flatnonzero(scores > self.box_threshold)
        boxes, scores = boxes[keep], scores[keep]
        phrases = [phrases[i] for i in keep]
        keep = box_nms(boxes, scores, self.iou_threshold)
        boxes, scores = boxes[keep], scores[keep]
        phrases = [phrases[i] for i in keep]
        if len(boxes) == 0:
            return None

        masks = np.asarray(self.segmenter(image, boxes))
        assert masks.shape[0] == len(boxes), (masks.shape, len(boxes))

        # captions first, then ONE batched embedder call for the whole
        # image: [category_0..n-1, composed_caption for the big ones]
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        composed: list[str | None] = []
        for box, phrase, area in zip(boxes, phrases, areas):
            if area >= self.min_caption_area:
                composed.append(
                    compose_instance_caption(
                        phrase, self.captioner(image, box)
                    )
                )
            else:
                composed.append(None)
        texts = list(phrases) + [c for c in composed if c is not None]
        embs = self.embedder(texts)
        cat_embs, cap_embs = embs[: len(phrases)], embs[len(phrases):]

        h, w = image.shape[:2]
        record = {
            "caption": caption,
            "width": w,
            "height": h,
            "file_name": file_name,
            "is_det": 1,
            "image": encode_image_b64(image),
            "dataset_name": self.dataset_name,
            "data_id": 1,
            "annos": [],
        }
        cap_i = 0
        for idx, (box, score, phrase, cap) in enumerate(
            zip(boxes, scores, phrases, composed)
        ):
            x1, y1, x2, y2 = (int(v) for v in box)
            bbox_xywh = [x1, y1, x2 - x1, y2 - y1]
            rle = geo.rle_encode(masks[idx].astype(np.uint8))
            anno = base_anno(
                bbox_xywh,
                float(score),
                idx + 1,
                rle,
                phrase,
                bbox_xywh[2] * bbox_xywh[3],
            )
            anno["text_embedding_before"] = _b64_floats(cat_embs[idx])
            if cap is not None:
                anno["caption"] = cap
                anno["blip_clip_embeddings"] = _b64_floats(cap_embs[cap_i])
                cap_i += 1
            record["annos"].append(anno)
        return record

    def run(
        self,
        entries: list[dict],
        output_dir: str,
        num_jobs: int = 1,
        job_index: int = 0,
        resume: bool = True,
        load_image=None,
    ) -> list[str]:
        """entries: [{"image": path, "caption": str}] (the reference's
        train_data_path format, :424-431). Returns written paths."""
        if load_image is None:
            load_image = _load_image_rgb
        os.makedirs(output_dir, exist_ok=True)
        lo, hi = shard_bounds(len(entries), num_jobs, job_index)
        written = []
        for entry in entries[lo:hi]:
            name = os.path.splitext(os.path.basename(entry["image"]))[0]
            out_path = os.path.join(output_dir, f"label_{name}.json")
            if resume and os.path.exists(out_path):
                written.append(out_path)
                continue
            record = self.label_image(
                load_image(entry["image"]), entry.get("caption", ""), name
            )
            if record is None:
                continue
            with open(out_path, "w") as f:
                json.dump(record, f)
            written.append(out_path)
        return written


def _load_image_rgb(path: str) -> np.ndarray:
    """A JPEG or PNG file as (H, W, 3) uint8 RGB, as PIL's convert("RGB")."""
    with open(path, "rb") as f:
        return decode_image(f.read())


def jsons_to_txt(json_dir: str, out_txt: str) -> int:
    """dataset-generation/jsons2txt.py: list every label json, one path
    per line, -> the JsonDataset train list."""
    paths = sorted(
        os.path.join(json_dir, f)
        for f in os.listdir(json_dir)
        if f.endswith(".json")
    )
    with open(out_txt, "w") as f:
        f.write("\n".join(paths) + ("\n" if paths else ""))
    return len(paths)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _oracle_pipeline(instances_json, embedder, args):
    from instancediffusion_tpu_torch.datagen.backends import CocoOracleBackend

    oracle = CocoOracleBackend(instances_json)

    def load(path):
        ok = oracle.select(os.path.basename(path))
        if not ok:
            raise KeyError(f"{path} not in {instances_json}")
        return _load_image_rgb(path)

    pipe = LabelingPipeline(
        oracle.tag, oracle.detect, oracle.segment, oracle.caption, embedder,
        box_threshold=args.box_threshold, iou_threshold=args.iou_threshold,
    )
    return pipe, load


def main(argv=None) -> list[str]:
    """The CLI; returns the record paths written or found (resume)."""
    p = argparse.ArgumentParser()
    p.add_argument("--train_data_path", required=True,
                   help='json: [{"image": path, "caption": str}, ...]')
    p.add_argument("--output_dir", "-o", required=True)
    p.add_argument("--instances_json", default=None,
                   help="COCO GT for the oracle backend (the only "
                        "in-repo backend; zoo backends plug in via the "
                        "datagen.backends Protocols)")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint for real CLIP phrase embeddings")
    p.add_argument("--num_jobs", type=int, default=1)
    p.add_argument("--job_index", type=int, default=0)
    p.add_argument("--box_threshold", type=float, default=0.25)
    p.add_argument("--iou_threshold", type=float, default=0.5)
    p.add_argument("--write_train_txt", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where --ckpt's CLIP tower runs: cuda (bf16) or cpu (float32)")
    args = p.parse_args(argv)

    from instancediffusion_tpu_torch.datagen import backends as B

    embedder = (
        B.ClipPhraseEmbedder(args.ckpt, device=args.device) if args.ckpt
        else B.zero_phrase_embedder
    )
    if not args.instances_json:
        p.error("no backend: pass --instances_json (oracle) or drive "
                "LabelingPipeline from python with zoo backends")
    pipe, load = _oracle_pipeline(args.instances_json, embedder, args)

    with open(args.train_data_path) as f:
        entries = json.load(f)
    written = pipe.run(
        entries, args.output_dir, num_jobs=args.num_jobs,
        job_index=args.job_index, load_image=load,
    )
    print(f"wrote {len(written)} records under {args.output_dir}")
    if args.write_train_txt:
        n = jsons_to_txt(args.output_dir, os.path.join(args.output_dir,
                                                       "train.txt"))
        print(f"train.txt: {n} entries")
    return written


if __name__ == "__main__":
    main()
