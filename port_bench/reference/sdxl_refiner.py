"""SDXL-Refiner 1.0 UNet of the plain reference, float32, no kernel.

The published model (Stability-AI/generative-models
`configs/inference/sd_xl_refiner.yaml`, UNetModel; Podell et al. 2023): 384
base channels, channel_mult (1, 2, 4, 4), 2 res blocks a level, spatial
transformers of depth 4 at ds 2 and 4 and in the middle (ds 8), heads of
`num_head_channels` = 64 (12 at C=768, 24 at C=1536), cross-attention over
a 1280-wide context (OpenCLIP-bigG penultimate states), and the ADM vector
y of 2560 = the projected pooled text then five 256-wide sinusoidal
embeddings (original height and width, crop top and left, aesthetic score)
through `label_emb` into the time embedding. eps prediction.

Built from the SD1.5 reference's blocks (`unet.py`: ResBlock, MHA, the
GEGLU feed-forward, openaimodel's plan walk), with transformer blocks that
have no fuser, so parameter names are the port's `models/sdxl_refiner.py`.

Departures from the published model:
- `proj_in` / `proj_out` are 1x1 convolutions over NHWC maps; sgm's
  `use_linear_in_transformer` makes them linear layers over the tokens,
  which is the same product on the same numbers.
- Attention is exact softmax attention in float32 (sgm's xformers kernel
  computes the same function).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from port_bench.reference import core as nn
from port_bench.reference.schedules import timestep_embedding
from port_bench.reference.unet import (
    MHA, ConvLayer, FeedForward, LayerSpec, OutHead, ResBlock, TimeEmbed, _apply_ff_geglu,
    _apply_mha, build_plan,
)


@dataclass
class RefinerUNetConfig:
    image_size: int = 128              # 1024 px latents
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 384
    attention_resolutions: tuple[int, ...] = (4, 2)
    num_res_blocks: int = 2
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_head_channels: int = 64
    transformer_depth: int = 4
    context_dim: int = 1280
    adm_in_channels: int = 2560
    efficient_attention: bool = True


class TransformerBlock(torch.nn.Module):
    """self-attention, cross-attention, GEGLU feed-forward; pre-LayerNorm."""

    def __init__(self, dim, context_dim, *, device=None):
        super().__init__()
        self.attn1 = MHA(dim, dim, dim, device=device)
        self.attn2 = MHA(dim, context_dim, dim, device=device)
        self.ff = FeedForward(dim, device=device)
        self.norm1 = nn.Norm(dim, device=device)
        self.norm2 = nn.Norm(dim, device=device)
        self.norm3 = nn.Norm(dim, device=device)

    def forward(self, x, context, num_heads):
        xn = nn.layer_norm(self.norm1, x)
        x = _apply_mha(self.attn1, xn, xn, num_heads) + x
        x = _apply_mha(self.attn2, nn.layer_norm(self.norm2, x), context, num_heads) + x
        return _apply_ff_geglu(self.ff, nn.layer_norm(self.norm3, x)) + x


class SpatialTransformer(torch.nn.Module):
    def __init__(self, ch, context_dim, depth, *, device=None):
        super().__init__()
        self.norm = nn.Norm(ch, device=device)
        self.proj_in = nn.Conv2d(ch, ch, 1, device=device)
        self.blocks = torch.nn.ModuleList(
            TransformerBlock(ch, context_dim, device=device) for _ in range(depth))
        self.proj_out = nn.Conv2d(ch, ch, 1, device=device)

    def forward(self, x, context, num_heads):
        b, h, w, c = x.shape
        t = nn.conv2d(self.proj_in, nn.group_norm(self.norm, x, eps=1e-6)).reshape(b, h * w, c)
        for blk in self.blocks:
            t = blk(t, context, num_heads)
        return nn.conv2d(self.proj_out, t.reshape(b, h, w, c)) + x


class RefinerUNet(torch.nn.Module):
    def __init__(self, cfg: RefinerUNetConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        input_plan, middle_plan, output_plan = build_plan(cfg)
        emb_ch = cfg.model_channels * 4

        def layer(spec: LayerSpec):
            if spec.kind == "res":
                return ResBlock(spec.in_ch, spec.out_ch, emb_ch, device=device)
            if spec.kind == "attn":
                return SpatialTransformer(spec.out_ch, cfg.context_dim, cfg.transformer_depth,
                                          device=device)
            return ConvLayer(spec.in_ch, spec.out_ch, device=device)

        self.time_embed = TimeEmbed(cfg.model_channels, emb_ch, device=device)
        self.label_emb = TimeEmbed(cfg.adm_in_channels, emb_ch, device=device)
        self.input_blocks = torch.nn.ModuleList(
            torch.nn.ModuleList(layer(s) for s in blk) for blk in input_plan)
        self.middle_block = torch.nn.ModuleList(layer(s) for s in middle_plan)
        self.output_blocks = torch.nn.ModuleList(
            torch.nn.ModuleList(layer(s) for s in blk) for blk in output_plan)
        self.out = OutHead(cfg.model_channels, cfg.out_channels, device=device)


def adm_vector(pooled_text: torch.Tensor, orig_size, crop, aesthetic_score: float):
    """y (B, 1280 + 5 * 256): the pooled text, then orig H, orig W, crop
    top, crop left and the aesthetic score, each embedded at 256 by the
    timestep formula (sgm's GeneralConditioner order)."""
    scalars = torch.tensor([orig_size[0], orig_size[1], crop[0], crop[1], aesthetic_score],
                           dtype=torch.float32, device=pooled_text.device)
    emb = timestep_embedding(scalars, 256).reshape(1, -1)
    return torch.cat([pooled_text.float(), emb.expand(pooled_text.shape[0], -1)], dim=1)


def apply_refiner_unet(p: RefinerUNet, x, timesteps, context, y):
    """eps. x (B,H,W,4) NHWC, timesteps (B,), context (B,77,1280), y
    (B,2560); float32 throughout."""
    cfg = p.cfg
    t_emb = timestep_embedding(timesteps, cfg.model_channels)
    emb = nn.linear(p.time_embed.l2, nn.silu(nn.linear(p.time_embed.l1, t_emb)))
    emb = emb + nn.linear(p.label_emb.l2, nn.silu(nn.linear(p.label_emb.l1, y.float())))
    context = context.float()
    input_plan, middle_plan, output_plan = build_plan(cfg)

    def run_layer(spec: LayerSpec, m, h):
        if spec.kind == "conv_in":
            return nn.conv2d(m.conv, h, padding=1)
        if spec.kind == "res":
            return m(h, emb)
        if spec.kind == "attn":
            return m(h, context, spec.out_ch // cfg.num_head_channels)
        if spec.kind == "down":
            return nn.conv2d(m.conv, h, stride=2, padding=1)
        return nn.conv2d(m.conv, nn.upsample_nearest_2x(h), padding=1)

    hs = []
    h = x.float()
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
