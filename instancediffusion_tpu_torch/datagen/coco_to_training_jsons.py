"""Convert a COCO-format detection/segmentation dataset into the per-image
training JSON records that `data/jsondataset.py` reads, and the train.txt
list (the port's counterpart of `tools/coco_to_training_jsons.py`, with the
same records from the port's `CocoAnnotations` and CLIP tower).

Record format (dataset/jsondataset.py + decode_item.py:284-317 of the
reference):
  {
    "data_id": int, "caption": str, "image": base64(the image file's bytes),
    "annos": [{
       "bbox": [x, y, w, h],                    # pixels
       "mask": {"size": [h, w], "counts": rle}, # COCO compressed RLE
       "caption": str,                          # instance phrase
       "text_embedding_before": base64(float32[768]),  # CLIP pooled phrase
    }, ...]
  }

Phrase embeddings come from the CLIP text tower of --ckpt on --device (one
batched encode per image's new phrases, memoized), else zeros (train-time
UniFusion replaces padded embeddings with learned nulls, so zero
embeddings degrade to location-only conditioning). A --ckpt that does not
exist raises (JAX's tool falls back to zeros).

    python -m instancediffusion_tpu_torch.datagen.coco_to_training_jsons \\
        --instances instances_train.json --captions captions_train.json \\
        --images_dir train2017 --out DATA/train [--ckpt model.pth] [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import json
import os

import numpy as np

from instancediffusion_tpu_torch.data.geometry import rle_encode
from instancediffusion_tpu_torch.datagen import backends
from instancediffusion_tpu_torch.evalsuite.coco_eval import CocoAnnotations


def main(argv=None) -> list[str]:
    """The CLI; returns the record paths written (train.txt's lines)."""
    p = argparse.ArgumentParser()
    p.add_argument("--instances", required=True)
    p.add_argument("--captions", default=None)
    p.add_argument("--images_dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt", default=None, help="for real CLIP phrase embeddings")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="where --ckpt's CLIP tower runs: cuda (bf16) or cpu (float32)")
    args = p.parse_args(argv)

    coco = CocoAnnotations(args.instances)
    captions = {}
    if args.captions:
        with open(args.captions) as f:
            for ann in json.load(f)["annotations"]:
                captions.setdefault(ann["image_id"], ann["caption"])

    if args.ckpt and not os.path.exists(args.ckpt):
        raise FileNotFoundError(f"--ckpt {args.ckpt} does not exist")
    embed = (backends.ClipPhraseEmbedder(args.ckpt, device=args.device) if args.ckpt
             else backends.zero_phrase_embedder)

    os.makedirs(args.out, exist_ok=True)
    listing = []
    ids = coco.image_ids()[: args.limit] if args.limit else coco.image_ids()
    for img_id in ids:
        info = coco.imgs[img_id]
        anns = [a for a in coco.img_anns[img_id] if not a.get("iscrowd", 0)]
        if not anns:
            continue
        img_path = os.path.join(args.images_dir, info["file_name"])
        if not os.path.exists(img_path):
            continue
        with open(img_path, "rb") as f:
            img_b64 = base64.b64encode(f.read()).decode()

        phrases = [coco.cats[a["category_id"]]["name"] for a in anns]
        embs = embed(phrases)
        annos = []
        for ann, phrase, emb in zip(anns, phrases, embs):
            mask = coco.ann_to_mask(ann, info)[:, :, 0]
            annos.append({
                "bbox": ann["bbox"],
                "mask": rle_encode(mask),
                "caption": phrase,
                "text_embedding_before": base64.b64encode(
                    np.asarray(emb, np.float32).tobytes()).decode(),
            })
        rec = {
            "data_id": img_id,
            "caption": captions.get(img_id, ""),
            "image": img_b64,
            "annos": annos,
        }
        out_path = os.path.join(args.out, f"{img_id}.json")
        with open(out_path, "w") as f:
            json.dump(rec, f)
        listing.append(out_path)

    with open(os.path.join(args.out, "train.txt"), "w") as f:
        f.write("\n".join(listing) + "\n")
    print(f"wrote {len(listing)} records + train.txt under {args.out}")
    return listing


if __name__ == "__main__":
    main()
