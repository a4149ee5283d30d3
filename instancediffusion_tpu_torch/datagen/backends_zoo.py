"""Model-zoo adapters for the labeling pipeline (counterpart of
`instancediffusion_tpu/datagen/backends_zoo.py`, its logic copied).

The reference's labeling fleet wires RAM -> GroundingDINO -> SAM -> BLIP-2
(dataset-generation/submitit_automatic_label_ram_save_json.py:366-516).
This module is the same wiring for `datagen.label.LabelingPipeline`, shaped
to the `datagen.backends` Protocols:

  RamTagger             Tagger     (reference :388-404, :468-476)
  GroundingDinoDetector Detector   (reference :180-212, :478-491)
  SamSegmenter          Segmenter  (reference :406-411, :483, :500-508)
  Blip2Captioner        Captioner  (reference :101-113, :415)

None of the zoo packages (`ram`, `groundingdino`, `segment_anything`,
`lavis`) nor their checkpoints ship with the port. Each adapter takes its
already-loaded model objects by constructor injection (testable with fakes)
and has a `from_pretrained` classmethod that imports its package only when
called (`_require`); on a host with the packages, `build_zoo_pipeline()`
turns the checkpoint paths into a ready LabelingPipeline.

The tensor contracts are the port's own, with numpy and torch and no
imaging library: ImageNet normalisation; RAM's 384x384 resize (Pillow's
default filter for RGB, BICUBIC) and DINO's shortest-side-800 / max-1333
BILINEAR resize through `data/resample`, bit for bit with Pillow; the
cxcywh -> xyxy pixel rescale; sigmoid-max scoring; posmap phrase decoding;
SAM's `predict_torch` call; BLIP's box crop as a numpy slice padded with
zeros where the box leaves the image, as `Image.crop` pads. A processor
that wants a PIL image (BLIP-2's) is wrapped inside `from_pretrained`,
where the zoo package has brought PIL. Each adapter's tensors go to its
`device` (`cuda` in `from_pretrained`). As in JAX, scores stay a separate
array, and thresholding and NMS live in the pipeline.
"""

from __future__ import annotations

import numpy as np

from instancediffusion_tpu_torch.data import resample

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _require(module: str, pip_hint: str):
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(
            f"datagen zoo backend needs the `{module}` package (install on the labeling "
            f"host: {pip_hint}); the port itself never depends on it — see "
            "datagen/backends_zoo.py") from e


# ---------------------------------------------------------------------------
# Pure preprocessing
# ---------------------------------------------------------------------------


def imagenet_chw_tensor(image: np.ndarray):
    """(H,W,3) uint8 -> torch float32 (3,H,W), /255 then ImageNet mean/std
    (the reference's ToTensor+Normalize, :388-393, :134-140)."""
    import torch

    x = (np.asarray(image, np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
    return torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1)))


def resize_shortest(image: np.ndarray, short: int = 800, max_size: int = 1333) -> np.ndarray:
    """GroundingDINO's RandomResize([800], max_size=1333) eval transform
    (reference :134-140): the short side to `short`, the long side capped at
    `max_size`; PIL's BILINEAR, bit for bit."""
    h, w = image.shape[:2]
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = round(h * scale), round(w * scale)
    return resample.resize(np.ascontiguousarray(image, np.uint8), (nw, nh), resample.BILINEAR)


def boxes_cxcywh_to_xyxy_pixels(boxes: np.ndarray, width: int, height: int) -> np.ndarray:
    """DINO's normalized cxcywh -> pixel xyxy (reference :487-491)."""
    b = np.asarray(boxes, np.float32) * np.array([width, height, width, height], np.float32)
    out = np.empty_like(b)
    out[:, :2] = b[:, :2] - b[:, 2:] / 2
    out[:, 2:] = b[:, :2] + b[:, 2:] / 2
    return out


def phrase_from_posmap(posmap: np.ndarray, input_ids: list[int], tokenizer) -> str:
    """groundingdino.util.get_phrases_from_posmap semantics (reference
    :208): decode the caption tokens whose per-token logit cleared the text
    threshold. Positions beyond the caption's token span are ignored."""
    ids = [input_ids[i] for i in np.flatnonzero(posmap) if i < len(input_ids)]
    return tokenizer.decode(ids)


def crop_box(image: np.ndarray, box) -> np.ndarray:
    """`Image.crop((x1, y1, x2, y2))` of int(box) as an array: rows y1..y2,
    columns x1..x2, zeros where the box leaves the image."""
    x1, y1, x2, y2 = (int(v) for v in box)
    if x2 < x1 or y2 < y1:
        raise ValueError(f"crop box {(x1, y1, x2, y2)}: right < left or lower < upper")
    h, w = image.shape[:2]
    out = np.zeros((y2 - y1, x2 - x1) + image.shape[2:], image.dtype)
    sx1, sy1, sx2, sy2 = max(x1, 0), max(y1, 0), min(x2, w), min(y2, h)
    if sx2 > sx1 and sy2 > sy1:
        out[sy1 - y1:sy2 - y1, sx1 - x1:sx2 - x1] = image[sy1:sy2, sx1:sx2]
    return out


# ---------------------------------------------------------------------------
# Adapters (constructor-injected models; from_pretrained = guarded loading)
# ---------------------------------------------------------------------------


class RamTagger:
    """Recognize-Anything tagging (reference :388-404, :468-476): the model
    sees a 384x384 ImageNet-normalized image; its '|'-separated tags are
    split into the Detector's tag list."""

    def __init__(self, model, inference_fn, device: str = "cpu", image_size: int = 384):
        self.model = model
        self.inference_fn = inference_fn
        self.device = device
        self.image_size = image_size

    def __call__(self, image: np.ndarray) -> list[str]:
        s = self.image_size
        small = resample.resize(np.ascontiguousarray(image, np.uint8), (s, s), resample.BICUBIC)
        x = imagenet_chw_tensor(small)[None].to(self.device)
        res = self.inference_fn(x, self.model)
        tag_str = res[0] if isinstance(res, (tuple, list)) else res
        return [t.strip() for t in tag_str.split("|") if t.strip()]

    @classmethod
    def from_pretrained(cls, checkpoint: str, device: str = "cuda",
                        image_size: int = 384) -> "RamTagger":
        ram_models = _require("ram.models", "pip install ram (Grounded-SAM zoo)")
        ram_inf = _require("ram", "pip install ram")
        model = ram_models.ram(pretrained=checkpoint, image_size=image_size,
                               vit="swin_l").eval().to(device)
        return cls(model, ram_inf.inference, device, image_size)


class GroundingDinoDetector:
    """Open-vocabulary detection (reference :180-212, :478-491). The caption
    is the lowercased ', '-joined tag list with a trailing '.'; scores are
    per-query sigmoid-logit maxima; phrases come from the text-threshold
    posmap over the caption tokens; boxes are returned in pixel xyxy."""

    def __init__(self, model, tokenizer=None, text_threshold: float = 0.2,
                 prefilter_threshold: float = 0.05, device: str = "cpu"):
        self.model = model
        self.tokenizer = tokenizer if tokenizer is not None else model.tokenizer
        self.text_threshold = text_threshold
        # near-zero queries go before phrase decoding (900 queries an image
        # otherwise); well below any useful pipeline box_threshold
        self.prefilter_threshold = prefilter_threshold
        self.device = device

    @staticmethod
    def compose_caption(tags: list[str]) -> str:
        caption = ", ".join(tags).lower().strip()
        return caption if caption.endswith(".") else caption + "."

    def __call__(self, image: np.ndarray, tags: list[str]):
        import torch

        caption = self.compose_caption(tags)
        x = imagenet_chw_tensor(resize_shortest(image))[None].to(self.device)
        with torch.no_grad():
            out = self.model(x, captions=[caption])
        logits = torch.sigmoid(out["pred_logits"]).cpu().numpy()[0]  # (nq, 256)
        boxes = out["pred_boxes"].cpu().numpy()[0]                   # (nq, 4)
        scores = logits.max(axis=1)
        keep = np.flatnonzero(scores > self.prefilter_threshold)
        logits, boxes, scores = logits[keep], boxes[keep], scores[keep]
        tokenized = self.tokenizer(caption)
        input_ids = (tokenized["input_ids"] if isinstance(tokenized, dict)
                     else tokenized.input_ids)
        phrases = [phrase_from_posmap(lg > self.text_threshold, input_ids, self.tokenizer)
                   for lg in logits]
        h, w = image.shape[:2]
        return boxes_cxcywh_to_xyxy_pixels(boxes, w, h), scores.astype(np.float32), phrases

    @classmethod
    def from_pretrained(cls, config: str, checkpoint: str, device: str = "cuda",
                        **kw) -> "GroundingDinoDetector":
        import torch

        gd_models = _require("groundingdino.models", "pip install groundingdino-py")
        gd_slconfig = _require("groundingdino.util.slconfig", "groundingdino-py")
        gd_utils = _require("groundingdino.util.utils", "groundingdino-py")
        args = gd_slconfig.SLConfig.fromfile(config)
        args.device = device
        model = gd_models.build_model(args)
        sd = torch.load(checkpoint, map_location="cpu")
        model.load_state_dict(gd_utils.clean_state_dict(sd["model"]), strict=False)
        return cls(model.eval().to(device), device=device, **kw)


class SamSegmenter:
    """Box-prompted segmentation through a SamPredictor (reference :483,
    :500-508): set_image once an image, the pixel-xyxy boxes into SAM's
    input frame, one mask each."""

    def __init__(self, predictor, device: str = "cpu"):
        self.predictor = predictor
        self.device = device

    def __call__(self, image: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        import torch

        if len(boxes) == 0:
            return np.zeros((0,) + image.shape[:2], bool)
        self.predictor.set_image(image)
        tb = self.predictor.transform.apply_boxes_torch(
            torch.as_tensor(np.asarray(boxes, np.float32)), image.shape[:2]).to(self.device)
        masks, _, _ = self.predictor.predict_torch(point_coords=None, point_labels=None,
                                                   boxes=tb, multimask_output=False)
        return masks[:, 0].cpu().numpy().astype(bool)

    @classmethod
    def from_pretrained(cls, checkpoint: str, device: str = "cuda",
                        hq: bool = False) -> "SamSegmenter":
        sam_mod = _require("segment_anything", "pip install segment-anything")
        build = sam_mod.build_sam_hq if hq else sam_mod.build_sam
        sam = build(checkpoint=checkpoint).to(device)
        return cls(sam_mod.SamPredictor(sam), device)


class Blip2Captioner:
    """Instance captions from box crops by BLIP-2 beam search (reference
    :101-113). `vis_processor` takes the (h, w, 3) uint8 crop (`crop_box`).
    The area gate and the category-prefix rule live in LabelingPipeline."""

    def __init__(self, model, vis_processor, device: str = "cpu"):
        self.model = model
        self.vis_processor = vis_processor
        self.device = device

    def __call__(self, image: np.ndarray, box: np.ndarray) -> str:
        tensor = self.vis_processor(crop_box(image, box))[None].to(self.device)
        return self.model.generate({"image": tensor})[0]

    @classmethod
    def from_pretrained(cls, device: str = "cuda", name: str = "blip2_t5",
                        model_type: str = "pretrain_flant5xl") -> "Blip2Captioner":
        lavis = _require("lavis.models", "pip install salesforce-lavis")
        model, vis_processors, _ = lavis.load_model_and_preprocess(
            name=name, model_type=model_type, is_eval=True, device=device)
        # lavis brings PIL, and its processor takes PIL images
        pil_image = _require("PIL.Image", "pip install pillow (a lavis dependency)")
        proc = vis_processors["eval"]
        return cls(model, lambda crop: proc(pil_image.fromarray(crop)), device)


# ---------------------------------------------------------------------------
# One-call fleet constructor
# ---------------------------------------------------------------------------


def build_zoo_pipeline(ram_checkpoint: str, dino_config: str, dino_checkpoint: str,
                       sam_checkpoint: str, clip_ckpt: str | None = None, device: str = "cuda",
                       sam_hq: bool = False, **pipeline_kw):
    """Checkpoint paths -> ready LabelingPipeline (the reference's main(),
    :366-415, as one call). clip_ckpt=None uses the zero embedder."""
    from instancediffusion_tpu_torch.datagen import backends as B
    from instancediffusion_tpu_torch.datagen.label import LabelingPipeline

    embedder = B.ClipPhraseEmbedder(clip_ckpt, device) if clip_ckpt else B.zero_phrase_embedder
    return LabelingPipeline(
        tagger=RamTagger.from_pretrained(ram_checkpoint, device),
        detector=GroundingDinoDetector.from_pretrained(dino_config, dino_checkpoint, device),
        segmenter=SamSegmenter.from_pretrained(sam_checkpoint, device, hq=sam_hq),
        captioner=Blip2Captioner.from_pretrained(device),
        embedder=embedder,
        **pipeline_kw,
    )
