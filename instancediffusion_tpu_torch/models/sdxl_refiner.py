"""SDXL-Refiner UNet, the cascade's second stage (counterpart of
`instancediffusion_tpu/models/sdxl_refiner.py`).

Architecture (public sgm config `sd_xl_refiner.yaml`, UNetModel section):
384 base channels, channel_mult (1,2,4,4), 2 res blocks a level, depth-4
spatial transformers at ds 2 and 4 (+ the middle at ds 8), head dim 64
(12 / 24 heads), cross-attention context 1280 (OpenCLIP-bigG penultimate
hidden states), and an ADM vector y of 2560 = the 1280-d projected pooled
text followed by five 256-d sinusoidal embeddings (orig H/W, crop top/left,
aesthetic score), added to the time embedding through `label_emb`.
Prediction target: eps. No fuser, ScaleU or first-conv swap: those are
InstanceDiffusion's SD1.5 additions.

It is built from the SD1.5 UNet's modules (`models/unet.py`) with the
transformer blocks' fuser left out, so parameter names mirror the JAX tree
(`input_blocks.4.1.blocks.0.attn1.to_q.weight`). On the card its bf16
forward takes the same kernels as the SD1.5 UNet, at its own shapes:
GroupNorm up to C=3072 (the decoder's 1536 + 1536 joins), LayerNorm at
C=768 / 1536, the fused GEGLU feed-forward at ds2 (C=768; ds4 and the
middle, C=1536, take the unfused route, as in the JAX package) and the
packed flash attention at ds2 (head dim 64); cross-attention over 77
tokens and ds4 / ds8 self-attention stay plain.
"""

from __future__ import annotations

import torch

from instancediffusion_tpu_torch.config import RefinerUNetConfig
from instancediffusion_tpu_torch.models.unet import (
    ConvLayer, LayerSpec, OutHead, ResBlock, SpatialTransformer, TimeEmbed, build_plan,
)
from instancediffusion_tpu_torch.nn import core as nn
from instancediffusion_tpu_torch.ops.schedules import timestep_embedding


# (input_blocks, middle_block, output_blocks) lists of LayerSpec: openaimodel's
# constructor walk, the same for the refiner's config as for SD1.5's (the
# refiner's blocks differ only in their transformers, built without fusers)
build_refiner_plan = build_plan


class RefinerUNet(torch.nn.Module):
    def __init__(self, cfg: RefinerUNetConfig, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(generator=generator, device=device)
        input_plan, middle_plan, output_plan = build_refiner_plan(cfg)
        emb_ch = cfg.model_channels * 4

        def layer(spec: LayerSpec):
            if spec.kind == "res":
                return ResBlock(spec.in_ch, spec.out_ch, emb_ch, **kw)
            if spec.kind == "attn":
                return SpatialTransformer(spec.out_ch, cfg.context_dim, cfg.transformer_depth,
                                          with_fuser=False, **kw)
            return ConvLayer(spec.in_ch, spec.out_ch, **kw)

        self.time_embed = TimeEmbed(cfg.model_channels, emb_ch, **kw)
        # the ADM conditioning MLP (openaimodel num_classes="sequential")
        self.label_emb = TimeEmbed(cfg.adm_in_channels, emb_ch, **kw)
        self.input_blocks = torch.nn.ModuleList(
            torch.nn.ModuleList(layer(s) for s in blk) for blk in input_plan)
        self.middle_block = torch.nn.ModuleList(layer(s) for s in middle_plan)
        self.output_blocks = torch.nn.ModuleList(
            torch.nn.ModuleList(layer(s) for s in blk) for blk in output_plan)
        self.out = OutHead(cfg.model_channels, cfg.out_channels, **kw)


def refiner_adm_vector(pooled_text: torch.Tensor, orig_size=(1024, 1024), crop=(0, 0),
                       aesthetic_score: float = 6.0) -> torch.Tensor:
    """ADM vector y (B, P + 1280) in sgm's GeneralConditioner order: the
    pooled projected text (P = 1280) first, then orig H/W, crop top/left and
    the aesthetic score, each embedded at dim 256 by the timestep formula
    (SDXL report §2.2; the negative batch conventionally takes aesthetic
    score 2.5). Computed in fp32, cast to the pooled text's dtype."""
    b = pooled_text.shape[0]
    scalars = torch.tensor([orig_size[0], orig_size[1], crop[0], crop[1], aesthetic_score],
                           dtype=torch.float32, device=pooled_text.device)
    emb = timestep_embedding(scalars, 256).reshape(1, -1).expand(b, 5 * 256)
    return torch.cat([pooled_text, emb.to(pooled_text.dtype)], dim=1)


def apply_refiner_unet(p: RefinerUNet, x, timesteps, context, y):
    """eps-prediction forward. x (B,H,W,4) NHWC, timesteps (B,), context
    (B,77,1280), y (B,2560) (`refiner_adm_vector`). Long attention goes to
    the flash kernel unless `plain_kernels()` is active."""
    cfg = p.cfg
    impl = "kernel" if cfg.efficient_attention and nn.kernels_enabled() else "plain"
    t_emb = timestep_embedding(timesteps, cfg.model_channels).to(x.dtype)
    emb = nn.linear(p.time_embed.l2, nn.silu(nn.linear(p.time_embed.l1, t_emb)))
    emb = emb + nn.linear(p.label_emb.l2, nn.silu(nn.linear(p.label_emb.l1, y.to(x.dtype))))
    context = context.to(x.dtype)
    input_plan, middle_plan, output_plan = build_refiner_plan(cfg)

    def run_layer(spec: LayerSpec, m, h):
        if spec.kind == "conv_in":
            return nn.conv2d(m.conv, h, padding=1)
        if spec.kind == "res":
            return m(h, emb)
        if spec.kind == "attn":
            return m(h, context, None, spec.out_ch // cfg.num_head_channels, 0.0, impl)
        if spec.kind == "down":
            return nn.conv2d(m.conv, h, stride=2, padding=1)
        if spec.kind == "up":
            return nn.conv2d(m.conv, nn.upsample_nearest_2x(h), padding=1)
        raise ValueError(spec.kind)

    hs = []
    h = x
    for specs, mods in zip(input_plan, p.input_blocks):
        for spec, m in zip(specs, mods):
            h = run_layer(spec, m, h)
        hs.append(h)
    for spec, m in zip(middle_plan, p.middle_block):
        h = run_layer(spec, m, h)
    for specs, mods in zip(output_plan, p.output_blocks):
        h = torch.cat([h, hs.pop()], dim=-1)
        for spec, m in zip(specs, mods):
            h = run_layer(spec, m, h)
    h = nn.group_norm(p.out.norm, h, act="silu")
    return nn.conv2d(p.out.conv, h, padding=1)
