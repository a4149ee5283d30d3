"""Demo CLI: instance-conditioned image generation from a demo JSON
(counterpart of `instancediffusion_tpu/inference.py`).

The same flags (--input_json/--num_images/--guidance_scale/--negative_prompt/
--ckpt/--seed/--alpha/--mis/--steps/--test_config/--use_masks/--output/
--sampler/--lora/--lora_scale/--img2img/--strength/--cascade_strength/
--refiner_ckpt), plus --device (default cuda), and the same demo-JSON schema
(caption, width/height, annos[] with bbox/mask/point/scribble/caption).
Writes the images and a box-outline image as PNGs into
OUTPUT/gc<scale>-seed<seed>-alpha<alpha>/, numbered after the files already
there. --cascade_strength > 0 also refines the images through the SDXL
refiner (`pipeline_refiner.py`: 20 DDIM steps at that strength, seeded
random weights unless --refiner_ckpt names sd_xl_refiner_1.0.safetensors)
and writes them as <n>_xl_s<strength>_n20.png.

Reference quirk reproduced by default: the demo path zeroes the decoded
binary masks before sampling scribbles/polygons/segs, so demos exercise
boxes+points (+explicit scribbles) only. Pass --use_masks to honor the
JSON's RLE masks.

Difference from the JAX CLI: the box image has the outlines only (no
phrase or caption text). --img2img reads a PNG or JPEG of any size and
resizes it with PIL's LANCZOS, as JAX's CLI does.

Usage:
  python -m instancediffusion_tpu_torch.inference --input_json demos/demo_fox_meadow.json \\
      --ckpt pretrained/instancediffusion_sd15.pth [--device cpu]

Without --ckpt (or when the file is missing) the pipeline runs on seeded
random weights. Weights and compute are bf16 on the card, float32 on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from instancediffusion_tpu_torch.config import Config, apply_test_preset
from instancediffusion_tpu_torch.data import geometry as geo
from instancediffusion_tpu_torch.data import resample
from instancediffusion_tpu_torch.data.jpeg import decode_image
from instancediffusion_tpu_torch.io.png import png_bytes


def parse_demo_json(path: str, use_masks: bool = False, rng=None) -> dict:
    """Demo JSON -> meta dict for the pipeline."""
    rng = rng or np.random.default_rng(0)
    with open(path) as f:
        data = json.load(f)

    width, height = data["width"], data["height"]
    boxes, masks, phrases, points_list, scribbles_list = [], [], [], [], []
    for anno in data["annos"]:
        if use_masks and anno.get("mask"):
            masks.append(geo.decode_to_binary_mask(anno["mask"]).astype(np.float32))
        else:
            masks.append(np.zeros((512, 512, 1), np.float32))
        boxes.append(anno.get("bbox", [0, 0, 0, 0]))
        if "point" in anno:
            points_list.append(anno["point"])
        if "scribble" in anno:
            scribbles_list.append(anno["scribble"])
        phrases.append(anno["caption"])

    locations = [geo.rescale_box_xywh(b, width, height) for b in boxes]
    if len(points_list) == len(locations):
        points = [geo.rescale_points(p, width, height) for p in points_list]
    else:
        points = [geo.point_from_box(b) for b in locations]

    if len(scribbles_list) == len(locations):
        scribbles = [
            geo.reorder_scribbles(geo.rescale_scribbles(s, width, height))
            for s in scribbles_list
        ]
        scribbles = [np.asarray(s, np.float32).reshape(-1).tolist() for s in scribbles]
    else:
        scribbles = []
        for m in masks:
            s = geo.sample_random_points_from_mask(m, 20, rng)
            scribbles.append(geo.convert_points(s, width, height))

    polygons, segs = [], []
    for m in masks:
        poly = geo.sample_sparse_points_from_mask(m, k=256, rng=rng)
        if poly is None:
            poly = [0.0] * 512
        polygons.append(geo.convert_points(poly, width, height))
        segs.append(geo.resize_nearest(m[:, :, 0], 512, 512).astype(np.float32))

    return {
        "prompt": data["caption"],
        "phrases": phrases,
        "locations": locations,
        "points": points,
        "scribbles": scribbles,
        "polygons": polygons,
        "segs": segs,
    }


def draw_boxes_image(locations) -> np.ndarray:
    """White 512x512x3 uint8 with a black outline 2 pixels wide inside each
    [0, 1] xyxy box, pixel for pixel as PIL's
    ImageDraw.rectangle(outline=..., width=2) draws it (no labels)."""
    size = 512
    img = np.full((size, size, 3), 255, np.uint8)
    outline_boxes(img, [[int(v * size) for v in box] for box in locations], (0, 0, 0))
    return img


def outline_boxes(img: np.ndarray, boxes, color, width: int = 2) -> None:
    """Draw, in place on a square (S, S, 3) uint8 image, an outline `width`
    pixels wide inside each pixel box (x0, y0, x1, y1), as PIL's
    ImageDraw.rectangle(outline=color, width=width) draws it."""
    size = img.shape[0]

    def hline(x0, y, x1):
        if 0 <= y < size:
            img[y, max(x0, 0):max(x1 + 1, 0)] = color

    def vline(x, ya, yb):  # from ya towards yb, yb itself left out
        lo, hi = (ya, yb - 1) if yb > ya else (yb + 1, ya)
        if 0 <= x < size and ya != yb:
            img[max(lo, 0):max(hi + 1, 0), x] = color

    for x0, y0, x1, y1 in boxes:
        if y0 > y1:
            y0, y1 = y1, y0
        for i in range(width):
            hline(x0, y0 + i, x1)
            hline(x0, y1 - i, x1)
            vline(x1 - i, y0 + width, y1 - width + 1)
            vline(x0 + i, y0 + width, y1 - width + 1)


def _write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def read_image(path: str, size: int) -> np.ndarray:
    """A PNG or JPEG as (size, size, 3) uint8 RGB (`data/jpeg.decode_image`),
    resized with PIL's LANCZOS as JAX's CLI resizes it
    (`data/resample.resize`)."""
    with open(path, "rb") as f:
        img = decode_image(f.read())
    return resample.resize(img, (size, size), resample.LANCZOS)


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--output", type=str, default="OUTPUT")
    p.add_argument("--num_images", type=int, default=8)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--negative_prompt", type=str, default=None)
    p.add_argument("--input_json", type=str, required=True)
    p.add_argument("--ckpt", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--alpha", type=float, default=0.75,
                   help="fraction of steps with grounding gate on")
    p.add_argument("--mis", type=float, default=0.36,
                   help="fraction of steps using Multi-Instance Sampler")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--cascade_strength", type=float, default=0.0,
                   help="SDXL-Refiner img2img pass (0 = off)")
    p.add_argument("--refiner_ckpt", type=str, default=None,
                   help="sd_xl_refiner_1.0.safetensors path (seeded random refiner "
                        "weights without it)")
    p.add_argument("--test_config", type=str, default="mask",
                   choices=["box", "point", "scribble", "mask", "all"],
                   help="modality preset (the reference's test_*.yaml)")
    p.add_argument("--use_masks", action="store_true",
                   help="honor demo JSON RLE masks (reference zeroes them)")
    p.add_argument("--lora", type=str, default=None,
                   help="LoRA checkpoint (kohya/diffusers .safetensors or torch "
                        "pickle) merged into the SD1.5 backbone at load time")
    p.add_argument("--lora_scale", type=float, default=1.0)
    p.add_argument("--sampler", type=str, default="plms",
                   choices=["plms", "dpm", "ddim"],
                   help="plms = reference protocol; dpm = DPM-Solver++(2M) "
                        "fast serving (use --steps 20 --mis 0); ddim = "
                        "eta-0 baseline")
    p.add_argument("--img2img", type=str, default=None,
                   help="input PNG at the model's resolution: edit THIS image "
                        "under the demo JSON's instance conditioning instead of "
                        "sampling from noise (PLMS, MIS off)")
    p.add_argument("--strength", type=float, default=0.5,
                   help="img2img: fraction of the schedule re-noised "
                        "(1.0 = full re-generation)")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)

    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline, default_dtype

    cfg = apply_test_preset(Config(), args.test_config)
    kw = dict(device=args.device, dtype=default_dtype(args.device),
              vae_encoder=args.img2img is not None)
    if args.ckpt and os.path.exists(args.ckpt):
        pipe = InstanceDiffusionPipeline.from_checkpoint(args.ckpt, cfg, **kw)
    else:
        if args.ckpt:
            print(f"warning: checkpoint {args.ckpt} not found; random init")
        pipe = InstanceDiffusionPipeline.random_init(cfg, seed=args.seed, **kw)

    if args.lora:
        stats = pipe.load_lora(args.lora, scale=args.lora_scale)
        print(f"lora: merged {stats['applied_unet']} unet + "
              f"{stats['applied_te']} text-encoder modules"
              + (f", {len(stats['unknown'])} unknown keys"
                 if stats["unknown"] else ""))

    meta = parse_demo_json(args.input_json, use_masks=args.use_masks,
                           rng=np.random.default_rng(args.seed))
    meta["alpha_type"] = [args.alpha, 0.0, 1 - args.alpha]

    if args.img2img:
        images = pipe.img2img(
            read_image(args.img2img, pipe.image_size),
            meta,
            strength=args.strength,
            num_images=args.num_images,
            steps=args.steps,
            guidance_scale=args.guidance_scale,
            alpha=args.alpha,
            seed=args.seed,
            negative_prompt=args.negative_prompt,
        )
    else:
        images = pipe.generate(
            meta,
            num_images=args.num_images,
            steps=args.steps,
            guidance_scale=args.guidance_scale,
            alpha=args.alpha,
            mis=args.mis,
            seed=args.seed,
            negative_prompt=args.negative_prompt,
            sampler=args.sampler,
        )

    folder = os.path.join(
        args.output, f"gc{args.guidance_scale}-seed{args.seed}-alpha{args.alpha}"
    )
    os.makedirs(folder, exist_ok=True)
    start = len(os.listdir(folder))

    _write_png(os.path.join(folder, f"{start}_boxes.png"), draw_boxes_image(meta["locations"]))
    paths = []
    if args.cascade_strength > 0:
        refined = _sdxl_refine(images, meta["prompt"], args.cascade_strength,
                               ckpt=args.refiner_ckpt, device=args.device)
        for i in range(refined.shape[0]):
            paths.append(os.path.join(folder, f"{start + i}_xl_s{args.cascade_strength}_n20.png"))
            _write_png(paths[-1], refined[i])
    for i in range(images.shape[0]):
        paths.append(os.path.join(folder, f"{start + i}.png"))
        _write_png(paths[-1], images[i])
    print(f"saved {images.shape[0]} images to {folder}")
    return paths


def _sdxl_refine(images, prompt, strength, steps=20, ckpt=None, device="cuda"):
    """The SDXL-Refiner cascade (`pipeline_refiner.py`) over uint8 images:
    refined (B, H, W, 3) uint8, truncated as the JAX CLI converts them.
    ckpt: sd_xl_refiner_1.0.safetensors; without it the refiner runs on
    seeded random weights."""
    from instancediffusion_tpu_torch.pipeline import default_dtype
    from instancediffusion_tpu_torch.pipeline_refiner import SDXLRefinerPipeline

    kw = dict(device=device, dtype=default_dtype(device))
    pipe = (SDXLRefinerPipeline.from_checkpoint(ckpt, **kw) if ckpt
            else SDXLRefinerPipeline.random_init(**kw))
    out = pipe.refine(np.asarray(images, np.float32) / 255.0, prompt, strength=strength,
                      steps=steps)
    return (out * 255).astype(np.uint8)


if __name__ == "__main__":
    main()
