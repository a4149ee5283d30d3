"""CLIP ViT vision tower and projection heads, the image side of the full
CLIPModel (counterpart of `instancediffusion_tpu/models/clip_vision.py`):
the judge of the attribute-binding evaluation
(eval/eval_attribute_binding.py:19-60 of the reference: image-text
similarity and nearest-label accuracy).

ViT-L/14: a 14x14 patch conv to 1024 channels, a CLS token and learned
positions (257), pre-LN, 24 transformer layers (16 heads of 64, MLP 4096,
quick-GELU), post-LN on the CLS token, a linear projection to the 768-d
shared space. `CLIPJudge.encode_images` / `encode_texts` return the
projected features of a batch (the metric L2-normalises them).

The judge runs in float32, as JAX's does. By the port's one dtype rule
(`kernels.kernel_dtype`) float32 routes every LayerNorm and attention to
the plain PyTorch versions, as JAX's default `impl="xla"` does
(`ops/attention.py`): this module launches no hand-written kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from instancediffusion_tpu_torch.config import TextEncoderConfig
from instancediffusion_tpu_torch.data.geometry import resize_cubic
from instancediffusion_tpu_torch.models.clip_text import (
    CLIPTextModel, Layer, apply_clip_text, quick_gelu,
)
from instancediffusion_tpu_torch.nn import core as nn
from instancediffusion_tpu_torch.ops.attention import multi_head_attention

CLIP_IMAGE_MEAN = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclass
class VisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    projection_dim: int = 768

    @property
    def num_positions(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


class CLIPVisionModel(torch.nn.Module):
    """The vision tower's parameters, named as JAX's tree."""

    def __init__(self, cfg: VisionConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        d = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size, bias=False, **kw)
        self.class_embedding = nn.param(torch.randn((d,), **kw) * 0.02)
        self.position_embedding = nn.param(torch.randn((cfg.num_positions, d), **kw) * 0.02)
        self.pre_ln = nn.Norm(d, device=device)
        self.layers = torch.nn.ModuleList(Layer(cfg, **kw) for _ in range(cfg.num_hidden_layers))
        self.post_ln = nn.Norm(d, device=device)
        self.visual_projection = nn.Linear(d, cfg.projection_dim, bias=False, **kw)


def apply_clip_vision(p: CLIPVisionModel, pixels: torch.Tensor) -> dict:
    """pixels: (B, 224, 224, 3) CLIP-normalised. Returns the pooled feature
    before the projection and `image_embeds` (projected, the shared-space
    feature)."""
    cfg = p.cfg
    b = pixels.shape[0]
    x = nn.conv2d(p.patch_embedding, pixels, stride=cfg.patch_size)
    x = x.reshape(b, -1, cfg.hidden_size)  # (B, 256, D)
    cls = p.class_embedding.to(x.dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + p.position_embedding.to(x.dtype)
    x = nn.layer_norm(p.pre_ln, x)
    for layer in p.layers:
        h = nn.layer_norm(layer.ln1, x)
        q, k, v = (nn.linear(lin, h) for lin in (layer.q, layer.k, layer.v))
        x = x + nn.linear(layer.out, multi_head_attention(q, k, v, cfg.num_attention_heads))
        h = nn.layer_norm(layer.ln2, x)
        x = x + nn.linear(layer.fc2, quick_gelu(nn.linear(layer.fc1, h)))
    pooled = nn.layer_norm(p.post_ln, x[:, 0])
    return {"pooler_output": pooled, "image_embeds": nn.linear(p.visual_projection, pooled)}


def preprocess_image(image_u8: np.ndarray, size: int = 224) -> np.ndarray:
    """uint8 HWC -> CLIP-normalised float32: the shorter side resized to
    `size` with OpenCV's INTER_CUBIC (`data/geometry.resize_cubic`), then a
    center crop; an empty crop gives zeros."""
    h, w = image_u8.shape[:2]
    if h == 0 or w == 0:
        return np.zeros((size, size, 3), np.float32)
    scale = size / min(h, w)
    nh, nw = max(size, int(round(h * scale))), max(size, int(round(w * scale)))
    img = resize_cubic(np.ascontiguousarray(image_u8), nw, nh)
    top, left = (nh - size) // 2, (nw - size) // 2
    img = img[top:top + size, left:left + size]
    img = img.astype(np.float32) / 255.0
    return (img - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD


class CLIPJudge(torch.nn.Module):
    """encode_images / encode_texts for the attribute-binding metric
    (`evalsuite/attribute_binding.score_image`): the vision tower, the CLIP
    text tower (`models/clip_text.py`) and the text projection, in float32
    on `device`. Random weights from `generator`; real ones from an HF
    CLIPModel state dict through `from_state_dict`, or from JAX trees
    through `io/jax_params.load_jax_params(judge, vision=, text=,
    text_projection=)`."""

    def __init__(self, vcfg: VisionConfig | None = None, tcfg: TextEncoderConfig | None = None,
                 tokenizer=None, *, generator=None, device="cuda"):
        super().__init__()
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CLIPJudge: device cuda but torch.cuda.is_available() is false "
                               "(pass device='cpu' to run on the CPU)")
        self.vcfg = vcfg or VisionConfig()
        self.tcfg = tcfg or TextEncoderConfig()
        kw = dict(generator=generator, device=device)
        self.vision = CLIPVisionModel(self.vcfg, **kw)
        self.text = CLIPTextModel(self.tcfg, **kw)
        self.text_projection = nn.Linear(self.tcfg.hidden_size, self.vcfg.projection_dim,
                                         bias=False, **kw)
        if tokenizer is None:
            from instancediffusion_tpu_torch.data.tokenizer import CLIPTokenizer

            tokenizer = CLIPTokenizer.load_default()
        self.tokenizer = tokenizer
        self.device = device
        self.eval()

    @classmethod
    def from_state_dict(cls, sd: dict, vcfg: VisionConfig | None = None,
                        tcfg: TextEncoderConfig | None = None, tokenizer=None,
                        device="cuda") -> "CLIPJudge":
        """A judge with the weights of an HF CLIPModel state dict (numpy
        arrays or tensors), through `io/torch_convert.convert_clip_model`."""
        from instancediffusion_tpu_torch.io.jax_params import load_jax_params
        from instancediffusion_tpu_torch.io.torch_convert import (
            convert_clip_model, to_numpy_state_dict,
        )

        judge = cls(vcfg, tcfg, tokenizer, device=device)
        vision, text, proj = convert_clip_model(to_numpy_state_dict(sd), judge.tcfg, judge.vcfg)
        load_jax_params(judge, vision=vision, text=text, text_projection=proj)
        return judge

    @torch.inference_mode()
    def encode_images(self, crops: list[np.ndarray]) -> np.ndarray:
        """(N, projection_dim) float32 features of uint8 crops, one batch."""
        x = np.stack([preprocess_image(c) for c in crops])
        x = torch.from_numpy(x).to(self.device, torch.float32)
        return apply_clip_vision(self.vision, x)["image_embeds"].float().cpu().numpy()

    @torch.inference_mode()
    def encode_texts(self, texts: list[str]) -> np.ndarray:
        """(N, projection_dim) float32 features of texts, one batch."""
        if getattr(self.tokenizer, "is_fallback", False):
            # refuses unless IDTPU_ALLOW_HASH_TOKENIZER=1
            self.tokenizer.require_real("CLIPJudge text encoding")
        ids = np.stack([self.tokenizer.encode(t) for t in texts])
        pooled = apply_clip_text(self.text, torch.from_numpy(ids).long().to(self.device))
        return nn.linear(self.text_projection, pooled["pooler_output"]).float().cpu().numpy()
