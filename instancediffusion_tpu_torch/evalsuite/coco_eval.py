"""COCO val2017 zero-shot generation on the port (counterpart of
`instancediffusion_tpu/evalsuite/coco_eval.py`, the reference's
eval_local.py): one 512x512 image per COCO image, named after its COCO file,
for an external detector (AP / AP50) and the PiM and attribute-binding
scores of this package.

The same metas as JAX's (the same rng draws per image), the same job
sharding, `--limit` and batching: `batch_size` images at a time through
`pipeline.generate_batch`. Without an imaging library: polygon masks are
rasterised by `data/geometry.fill_poly` (cv2.fillPoly), masks resized by
`resize_nearest` (cv2 INTER_NEAREST), and each image is written as Pillow
would write it for its file name's extension: `.jpg` / `.jpeg` through
`data/jpeg.encode_jpeg` (Pillow's default JPEG, byte for byte), `.png`
through `io/png`.

`--mesh` shards each batch over the ranks of a process group (torchrun,
or the launcher's --coordinator / --num_processes / --process_id on each
rank): every rank runs the same metas through `generate_batch(mesh=)` and
rank 0 alone writes the files, so the folder is the one-rank run's.

    python -m instancediffusion_tpu_torch.evalsuite.coco_eval \\
        --instances_json instances_val2017.json --ckpt_path model.pth [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from collections import defaultdict

import numpy as np

from instancediffusion_tpu_torch.data import geometry as geo
from instancediffusion_tpu_torch.evalsuite.attribute_binding import COLOR_LIST, TEXTURE_LIST


class CocoAnnotations:
    """Minimal COCO instances/captions JSON reader."""

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.imgs = {im["id"]: im for im in data["images"]}
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.img_anns = defaultdict(list)
        for ann in data["annotations"]:
            self.img_anns[ann["image_id"]].append(ann)

    def image_ids(self):
        return sorted(self.imgs.keys())

    def ann_to_mask(self, ann, img_info) -> np.ndarray:
        """Polygon or RLE segmentation -> (h, w, 1) binary mask: each polygon
        rounded to integer vertices and filled by its own cv2.fillPoly call,
        as JAX's reader does."""
        seg = ann["segmentation"]
        h, w = img_info["height"], img_info["width"]
        if isinstance(seg, dict):  # RLE
            return geo.rle_decode(seg).astype(np.uint8)
        m = np.zeros((h, w), np.uint8)
        for poly in seg:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            geo.fill_poly(m, [np.round(pts).astype(np.int32)], 1)
        return m[:, :, None]


def make_a_sentence(obj_names, clean=False):
    """Category names -> 'a, b, c' caption (decode_item.py:368-385)."""
    if clean:
        obj_names = [n[:-6] if "-other" in n else n for n in obj_names]
    return ", ".join(obj_names)


def build_meta_for_image(
    coco: CocoAnnotations,
    img_id: int,
    caption: str | None = None,
    max_objs: int = 30,
    attribute_mode: str | None = None,  # None | "colors" | "textures"
    rng: np.random.Generator | None = None,
    alpha: float = 0.8,
) -> dict | None:
    """eval_local.py:181-259 semantics for one image, with JAX's draws."""
    rng = rng or np.random.default_rng(img_id)
    img_info = coco.imgs[img_id]
    anns = [a for a in coco.img_anns[img_id] if not a.get("iscrowd", 0)]
    if not anns:
        return None
    w, h = img_info["width"], img_info["height"]

    locations = [
        [b[0] / w, b[1] / h, (b[0] + b[2]) / w, (b[1] + b[3]) / h]
        for b in (ann["bbox"] for ann in anns)
    ][:max_objs]

    polygons, scribbles, segs = [], [], []
    for ann in anns[:max_objs]:
        # prepare_scribble_and_instmask (utils/input.py:161-186)
        m = coco.ann_to_mask(ann, img_info)
        m512 = geo.resize_nearest(m[:, :, 0], 512, 512)[:, :, None]
        scr = geo.sample_random_points_from_mask(m512, 20, rng)
        scribbles.append(geo.convert_points(scr, w, h))
        poly = geo.sample_sparse_points_from_mask(m, k=256, rng=rng)
        if poly is None:
            poly = [0.0] * 512
        polygons.append(geo.convert_points(poly, w, h))
        segs.append(m512.astype(np.float32)[:, :, 0])

    points = [geo.point_from_box(b) for b in locations]

    cat_names = [coco.cats[ann["category_id"]]["name"] for ann in anns]
    if attribute_mode == "colors":
        cat_names = [f"{COLOR_LIST[ann['id'] % len(COLOR_LIST)]} {n}"
                     for ann, n in zip(anns, cat_names)]
    elif attribute_mode == "textures":
        cat_names = [f"{TEXTURE_LIST[ann['id'] % len(TEXTURE_LIST)]} {n}"
                     for ann, n in zip(anns, cat_names)]
    phrases = cat_names[:max_objs]

    prompt = make_a_sentence(cat_names)
    if caption:
        prompt = caption + prompt

    return {
        "file_name": img_info["file_name"],
        "prompt": prompt,
        "phrases": phrases,
        "locations": locations,
        "points": points,
        "scribbles": scribbles,
        "polygons": polygons,
        "segs": segs,
        "alpha_type": [alpha, 0.0, 1.0 - alpha],
    }


def image_file_bytes(img: np.ndarray, file_name: str) -> bytes:
    """The bytes Pillow's `Image.fromarray(img).save(file_name)` writes for a
    (H, W, 3) uint8 image, by the name's extension: JPEG (byte for byte) or
    PNG (the same pixels); any other extension raises."""
    from instancediffusion_tpu_torch.data.jpeg import encode_jpeg
    from instancediffusion_tpu_torch.io.png import png_bytes

    ext = os.path.splitext(file_name)[1].lower()
    if ext in (".jpg", ".jpeg"):
        return encode_jpeg(img)
    if ext == ".png":
        return png_bytes(img)
    raise ValueError(f"{file_name}: only .jpg, .jpeg and .png are written")


def run_coco_eval(
    pipe,
    instances_json: str,
    out_dir: str,
    captions_json: str | None = None,
    num_jobs: int = 1,
    job_index: int = 0,
    limit: int | None = None,
    steps: int = 50,
    guidance_scale: float = 7.5,
    alpha: float = 0.8,
    mis: float = 0.0,
    attribute_mode: str | None = None,
    seed: int = 0,
    batch_size: int = 8,
    sampler: str | None = None,
    stats: dict | None = None,
    mesh=None,
) -> int:
    """Generate one image per COCO image (without a crowd-free annotation
    the image is skipped) under its COCO file name in `out_dir`,
    `batch_size` at a time through `pipe.generate_batch` with the seeds
    seed + image id, in sorted id order. mis > 0 batches the same way
    (generate_batch pads every image to one trajectory count). Returns the
    number of images written; `stats`, when given, receives the seconds of
    each batch (`batch_s`, generation and writing) and the pipeline's
    `last_timings` of each batch. With a `mesh` every rank calls it and
    generates its rows of each batch; rank 0 alone writes (the others
    return the count rank 0 writes)."""
    from instancediffusion_tpu_torch.parallel.mesh import rank_and_world

    writes = rank_and_world()[0] == 0
    coco = CocoAnnotations(instances_json)
    captions = {}
    if captions_json:
        with open(captions_json) as f:
            cap_data = json.load(f)
        for ann in cap_data["annotations"]:
            captions.setdefault(ann["image_id"], ann["caption"])

    # this job's contiguous share of the sorted ids (eval_local.py:173-177)
    ids = coco.image_ids()
    per_job = len(ids) // num_jobs + 1
    ids = ids[job_index * per_job:min((job_index + 1) * per_job, len(ids))]
    if limit:
        ids = ids[:limit]
    if writes:
        os.makedirs(out_dir, exist_ok=True)
    metas = []
    for img_id in ids:
        meta = build_meta_for_image(
            coco, img_id, captions.get(img_id), attribute_mode=attribute_mode,
            rng=np.random.default_rng(seed + img_id), alpha=alpha,
        )
        if meta is not None:
            metas.append((img_id, meta))

    done = 0
    for i in range(0, len(metas), batch_size):
        t0 = time.perf_counter()
        chunk = metas[i:i + batch_size]
        imgs = pipe.generate_batch(
            [m for _, m in chunk], steps=steps, guidance_scale=guidance_scale,
            alpha=alpha, seeds=[seed + img_id for img_id, _ in chunk], mis=mis,
            sampler=sampler, mesh=mesh,
        )
        for (_, meta), img in zip(chunk, imgs):
            if writes:
                with open(os.path.join(out_dir, meta["file_name"]), "wb") as f:
                    f.write(image_file_bytes(img, meta["file_name"]))
            done += 1
        if stats is not None:
            stats.setdefault("batch_s", []).append(time.perf_counter() - t0)
            stats.setdefault("last_timings", []).append(dict(pipe.last_timings))
    return done


def build_parser() -> argparse.ArgumentParser:
    """JAX's flags (eval_local.py:118-140) and --device."""
    p = argparse.ArgumentParser("COCO val2017 generation for AP/PiM eval")
    p.add_argument("--instances_json", type=str, required=True)
    p.add_argument("--captions_json", type=str, default=None)
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--save_dir", type=str, default="generation_samples/cocoval17")
    p.add_argument("--num_jobs", type=int, default=1)
    p.add_argument("--job_index", type=int, default=0)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--alpha", type=float, default=0.8)
    p.add_argument("--mis", type=float, default=0.0)
    p.add_argument("--test_config", type=str, default="mask")
    p.add_argument("--add_random_colors", action="store_true")
    p.add_argument("--add_random_textures", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--mesh", action="store_true",
                   help="shard the eval batch over the ranks (torchrun or the flags below)")
    p.add_argument("--sampler", type=str, default="plms", choices=["plms", "dpm", "ddim"],
                   help="plms = the reference eval protocol; dpm = "
                        "DPM-Solver++(2M) fast serving (requires --mis 0)")
    p.add_argument("--device", type=str, default=None,
                   help="cuda (bf16; cuda:LOCAL_RANK with --mesh) or cpu (float32)")
    from instancediffusion_tpu_torch.launch import add_dist_args

    add_dist_args(p)
    return p


def main(argv=None) -> dict:
    """The CLI. Returns {"images", "seconds", "s_per_image", "batch_s",
    "last_timings", "save_dir"} (the seconds from the first batch to the
    last file written, the pipeline's load excluded)."""
    args = build_parser().parse_args(argv)
    import torch

    from instancediffusion_tpu_torch.config import Config, apply_test_preset
    from instancediffusion_tpu_torch.pipeline import InstanceDiffusionPipeline, default_dtype

    mesh, device = None, torch.device(args.device or "cuda")
    if args.mesh:
        from instancediffusion_tpu_torch.launch import join
        from instancediffusion_tpu_torch.parallel.mesh import make_mesh

        args.multihost = True  # torchrun's environment unless --coordinator is given
        device = torch.device(join(args)[0])
        mesh = make_mesh()
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("coco_eval: --device cuda but torch.cuda.is_available() is false "
                           "(pass --device cpu to run on the CPU)")
    cfg = apply_test_preset(Config(), args.test_config)
    dtype = default_dtype(device)
    if args.ckpt_path:
        # JAX's driver evaluates random weights when the file is missing
        if not os.path.exists(args.ckpt_path):
            raise FileNotFoundError(f"--ckpt_path {args.ckpt_path} does not exist")
        pipe = InstanceDiffusionPipeline.from_checkpoint(args.ckpt_path, cfg, device=device,
                                                         dtype=dtype)
    else:
        pipe = InstanceDiffusionPipeline.random_init(cfg, device=device, dtype=dtype)

    attribute_mode = ("colors" if args.add_random_colors
                      else "textures" if args.add_random_textures else None)
    stats: dict = {}
    t0 = time.perf_counter()
    n = run_coco_eval(
        pipe, args.instances_json, args.save_dir, captions_json=args.captions_json,
        num_jobs=args.num_jobs, job_index=args.job_index, limit=args.limit, steps=args.steps,
        guidance_scale=args.guidance_scale, alpha=args.alpha, mis=args.mis,
        attribute_mode=attribute_mode, seed=args.seed, batch_size=args.batch_size,
        sampler=args.sampler, stats=stats, mesh=mesh,
    )
    seconds = time.perf_counter() - t0
    s_img = seconds / n if n else float("nan")
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    print(f"generated {n} images in {args.save_dir} ({s_img:.4f} s/image)")
    return {"images": n, "seconds": seconds, "s_per_image": s_img, "save_dir": args.save_dir,
            "batch_s": stats.get("batch_s", []), "last_timings": stats.get("last_timings", [])}


if __name__ == "__main__":
    main()
