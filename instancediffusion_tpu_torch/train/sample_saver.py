"""In-training visual inspection (counterpart of
`instancediffusion_tpu/train/sample_saver.py`): run the full sampler on
training batches and write image grids with GT-box overlays + captions.

The reference's de-facto training test (utils/checkpoint.py:146-212 +
ImageCaptionSaver :74-101): rank 0 samples 50-step PLMS with CFG 5.0 on
the LIVE weights, the negative prompt being CLIP of the empty string, and
writes (generated | real) grids, the generated half with 2-pixel red box
outlines, as batch<i>.png, and the batches' captions as captions.txt.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from instancediffusion_tpu_torch.config import Config
from instancediffusion_tpu_torch.inference import outline_boxes
from instancediffusion_tpu_torch.io.png import png_bytes
from instancediffusion_tpu_torch.models import clip_text, unet, unifusion, vae
from instancediffusion_tpu_torch.ops.schedules import make_diffusion_schedule
from instancediffusion_tpu_torch.pipeline import default_dtype
from instancediffusion_tpu_torch.samplers.plms import make_plms_schedule, plms_sample


def draw_boxes_on(image_u8: np.ndarray, boxes01: np.ndarray, masks: np.ndarray) -> np.ndarray:
    """A copy of a square uint8 image with a red outline 2 pixels wide inside
    each live box, as the JAX package draws it with PIL's
    ImageDraw.rectangle(width=2) (pixel corners (box * size) truncated, in
    float32)."""
    img = np.array(image_u8, np.uint8)
    s = image_u8.shape[0]
    boxes = [(np.asarray(box, np.float32) * s).astype(int).tolist()
             for box, m in zip(boxes01, masks) if m > 0]
    outline_boxes(img, boxes, (255, 0, 0))
    return img


def empty_caption_uc_ids(tokenizer) -> np.ndarray:
    """(77,) token ids of the EMPTY STRING — the CFG negative the reference
    samples with (uc = text_encoder.encode(batch*[""]),
    utils/checkpoint.py:173). CLIP("") is a real SOT/EOT embedding, not
    zeros."""
    return np.asarray(tokenizer.encode(""), np.int32)


def _to(device, a, dtype=None):
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=dtype)


@torch.no_grad()
def save_train_samples(
    cfg: Config,
    state,                       # train_step.TrainState
    batches: list[dict],
    out_dir: str,
    steps: int = 50,
    guidance_scale: float = 5.0,   # reference: utils/checkpoint.py:190
    seed: int = 0,
    tokenizer=None,
    initial_noise: list | None = None,
) -> list[str]:
    """Generate one sample per batch row on the live weights, save the grids
    and captions.txt; returns the grid paths. Batch bi starts from standard
    normal noise of a torch.Generator on the device seeded seed + bi, or
    from initial_noise[bi] ((b, h, w, C) arrays) when given. The UNet and
    VAE activations are bf16 on the card and float32 on the CPU
    (`pipeline.default_dtype`); UniFusion's grounding stays fp32, as in the
    JAX package."""
    os.makedirs(out_dir, exist_ok=True)
    dev = next(state.unet.parameters()).device
    dt = default_dtype(dev)
    if tokenizer is None:
        from instancediffusion_tpu_torch.data.tokenizer import CLIPTokenizer

        tokenizer = CLIPTokenizer.load_default()
    empty_ids = empty_caption_uc_ids(tokenizer)
    dc = cfg.diffusion
    sched = make_plms_schedule(
        make_diffusion_schedule(dc.beta_schedule, dc.timesteps, dc.linear_start, dc.linear_end),
        steps, [0.75, 0.0, 0.25])
    mcfg = cfg.model
    gcfg = mcfg.grounding_tokenizer
    drops = unifusion.ModalityDrops.test_defaults(gcfg)
    lat = mcfg.image_size

    captions_log, paths = [], []
    for bi, batch in enumerate(batches):
        b = batch["image"].shape[0]
        if initial_noise is not None:
            x_init = _to(dev, initial_noise[bi], torch.float32)
        else:
            gen = torch.Generator(device=dev).manual_seed(seed + bi)
            x_init = torch.randn((b, lat, lat, mcfg.in_channels), generator=gen, device=dev)
        x_init = x_init.to(dt)
        grounding = {
            "boxes": batch["boxes"], "masks": batch["masks"],
            "text_masks": batch.get("text_masks", batch["masks"]),
            "positive_embeddings": batch["text_embeddings"], "scribbles": batch["scribbles"],
            "polygons": batch["polygons"], "segs": batch["segs"], "points": batch["points"],
        }
        grounding = {k: _to(dev, v, torch.float32) for k, v in grounding.items()}
        ids = _to(dev, batch["caption_ids"]).long()
        uc_ids = torch.from_numpy(np.tile(empty_ids[None, :], (b, 1))).long().to(dev)
        context = clip_text.apply_clip_text(state.clip, ids)["last_hidden_state"].to(dt)
        uc = clip_text.apply_clip_text(state.clip, uc_ids)["last_hidden_state"].to(dt)
        objs_c = unifusion.apply_unifusion(state.unet.position_net, gcfg, grounding, drops)
        null_g = unifusion.null_grounding(b, mcfg.max_objs, gcfg, device=dev)
        objs_u = unifusion.apply_unifusion(state.unet.position_net, gcfg, null_g, drops)
        objs2 = torch.cat([objs_c, objs_u])
        ctx2 = torch.cat([context, uc])

        def model_fn(x, t, gate):
            x2 = torch.cat([x, x]).to(dt)
            eps2 = unet.apply_unet(state.unet, mcfg, x2, torch.cat([t, t]), ctx2,
                                   gate_scale=gate, precomputed_objs=objs2)
            ec, eu = eps2.chunk(2)
            return eu + guidance_scale * (ec - eu)

        z = plms_sample(model_fn, sched, x_init)
        img = vae.vae_decode(state.vae, z.to(dt)).float()
        imgs = torch.floor((img.clamp(-1.0, 1.0) * 0.5 + 0.5) * 255.0).to(torch.uint8).cpu().numpy()
        real = ((np.asarray(batch["image"]) * 0.5 + 0.5) * 255).astype(np.uint8)
        boxes, masks = np.asarray(batch["boxes"]), np.asarray(batch["masks"])
        rows = [np.concatenate([draw_boxes_on(imgs[i], boxes[i], masks[i]), real[i]], axis=1)
                for i in range(b)]
        path = os.path.join(out_dir, f"batch{bi}.png")
        with open(path, "wb") as f:
            f.write(png_bytes(np.concatenate(rows, axis=0)))
        paths.append(path)
        caps = batch.get("caption", [str(i) for i in range(b)])
        captions_log.append(f"batch{bi}: " + " | ".join(map(str, caps)))
    with open(os.path.join(out_dir, "captions.txt"), "w") as f:
        f.write("\n".join(captions_log) + "\n")
    return paths
